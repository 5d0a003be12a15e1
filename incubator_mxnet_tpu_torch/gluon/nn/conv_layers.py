"""Convolution and pooling layers of the ResNet path (port of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv2D``,
``MaxPool2D`` and ``GlobalAvgPool2D``, NCHW, as ``nn.Module``s."""
from __future__ import annotations

import torch
from torch import nn

from ... import context
from ...ops import nn as ops

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(nn.Module):
    """2-D convolution; weight (channels, in_channels, kh, kw)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 use_bias=True, in_channels=0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("Conv2D needs in_channels: the port has no "
                             "deferred shape inference")
        dev = context.resolve(device)
        self._stride = _pair(strides)
        self._pad = _pair(padding)
        self.weight = nn.Parameter(torch.empty(
            (channels, in_channels) + _pair(kernel_size), device=dev))
        self.bias = nn.Parameter(torch.zeros((channels,), device=dev)) \
            if use_bias else None

    def forward(self, x):
        return ops.convolution(x, self.weight, self.bias, self._stride,
                               self._pad)


class MaxPool2D(nn.Module):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0):
        super().__init__()
        self._kernel = _pair(pool_size)
        self._stride = _pair(strides) if strides is not None else self._kernel
        self._pad = _pair(padding)

    def forward(self, x):
        return ops.pooling(x, self._kernel, "max", stride=self._stride,
                           pad=self._pad)


class GlobalAvgPool2D(nn.Module):
    def forward(self, x):
        return ops.pooling(x, pool_type="avg", global_pool=True)
