"""Activation layers (port of ``incubator_mxnet_tpu/gluon/nn/
activations.py``): ``Activation``."""
from __future__ import annotations

from torch import nn

from ...ops import nn as ops

__all__ = ["Activation"]


class Activation(nn.Module):
    """``Activation(act_type)``: relu, sigmoid, tanh, softrelu or
    softsign (``ops.activation``)."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return ops.activation(x, self._act_type)
