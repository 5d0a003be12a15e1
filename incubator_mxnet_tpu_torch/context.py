"""Devices (port of ``incubator_mxnet_tpu/context.py``'s ``cpu()``/``gpu()``).

The port runs on the card.  Its entry points take ``device=`` and resolve
it here: ``None`` means :func:`default_device`, which is CUDA, and asking
for CUDA on a host without a card raises.  Nothing falls back to the CPU
unless the caller asked for ``"cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["cpu", "gpu", "default_device", "resolve"]


def cpu():
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def default_device():
    """The first CUDA card; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' (ctx=mx.cpu() for nd arrays) to run on the CPU")
    return gpu(0)


def resolve(device=None):
    """``device`` as a ``torch.device``; ``None`` is the default CUDA card."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but no CUDA device is "
                           "available" % dev)
    if dev.type == "cuda" and dev.index is None:
        dev = gpu(torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("the port runs on 'cuda' or 'cpu', got %s" % dev)
    return dev
