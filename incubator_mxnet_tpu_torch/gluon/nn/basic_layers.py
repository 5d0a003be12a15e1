"""Basic layers of the ResNet path (port of ``incubator_mxnet_tpu/gluon/nn/
basic_layers.py``): ``Dense``, ``Flatten`` and ``HybridSequential``, as
``nn.Module``s.  Parameters are created on ``device`` (default: the CUDA
card) with no values; ``initializer.initialize`` fills them.  The port
has no deferred shape inference, so input widths are given."""
from __future__ import annotations

import torch
from torch import nn

from ... import context
from ...ops import nn as ops

__all__ = ["Dense", "Flatten", "HybridSequential"]


class HybridSequential(nn.Sequential):
    """Children run in order; a tuple output (a dual block exit) is handed
    to the next child as one value."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)


class Dense(nn.Module):
    """Fully connected layer over the flattened input: weight (units,
    in_units), bias (units,)."""

    def __init__(self, units, use_bias=True, in_units=0, device=None):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense needs in_units: the port has no deferred "
                             "shape inference")
        dev = context.resolve(device)
        self.weight = nn.Parameter(torch.empty((units, in_units), device=dev))
        self.bias = nn.Parameter(torch.zeros((units,), device=dev)) \
            if use_bias else None

    def forward(self, x):
        return ops.fully_connected(x, self.weight, self.bias)


class Flatten(nn.Module):
    def forward(self, x):
        return ops.flatten(x)
