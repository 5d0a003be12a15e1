"""Devices (port of ``incubator_mxnet_tpu/context.py``'s ``cpu()``/``gpu()``).

The port runs on the card.  Its entry points take ``device=`` and resolve
it here: ``None`` means :func:`default_device`, which is CUDA, and asking
for CUDA on a host without a card raises.  Nothing falls back to the CPU
unless the caller asked for ``"cpu"``.  A model built inside
:func:`device_scope` hands its device to every layer built there that is
given none.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["cpu", "gpu", "default_device", "resolve", "device_scope"]

_SCOPE = threading.local()


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
    """``device`` as a ``torch.device``; ``None`` is the enclosing
    :func:`device_scope`'s device, else the default CUDA card."""
    if device is None:
        scoped = getattr(_SCOPE, "device", None)
        return scoped if scoped is not None else default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but no CUDA device is "
                           "available" % dev)
    if dev.type == "cuda" and dev.index is None:
        dev = gpu(torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("the port runs on 'cuda' or 'cpu', got %s" % dev)
    return dev


@contextlib.contextmanager
def device_scope(device=None):
    """Resolve ``device`` once and make it what :func:`resolve` returns for
    ``None`` inside the block (this thread only): a model's constructor
    builds its layers inside one."""
    prev = getattr(_SCOPE, "device", None)
    _SCOPE.device = resolve(device)
    try:
        yield _SCOPE.device
    finally:
        _SCOPE.device = prev
