"""Basic layers (port of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``):
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``, ``Flatten``
and ``HybridLambda``, as ``nn.Module``s.  Parameters are created on
``device`` (default: the enclosing ``context.device_scope``, else the
CUDA card) with no values; ``initializer.initialize`` fills them.  A
width left at 0 is deferred to the first input (``gluon.block``)."""
from __future__ import annotations

import math

from torch import nn

from ... import context
from ...ops import nn as ops
from ..block import F, Deferred

__all__ = ["HybridSequential", "Dense", "Dropout", "BatchNorm", "Flatten",
           "HybridLambda"]


class HybridSequential(nn.Sequential):
    """Children run in order; a tuple output (a dual block exit) is handed
    to the next child as one value."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)


class Dense(Deferred, nn.Module):
    """Fully connected layer over the flattened input: weight (units,
    in_units), bias (units,), an optional activation after it."""

    def __init__(self, units, activation=None, use_bias=True, in_units=0,
                 device=None):
        super().__init__()
        dev = context.resolve(device)
        self._units = units
        self._activation = activation
        self._param("weight", (units, in_units) if in_units else None, dev)
        if use_bias:
            self._param("bias", (units,), dev, fill=0.0)
        else:
            self.bias = None

    def _infer_shapes(self, x):
        return {"weight": (self._units, math.prod(x.shape[1:]))}

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias)
        if self._activation:
            out = ops.activation(out, self._activation)
        return out


class Dropout(nn.Module):
    """``Dropout(rate, axes)``: active in training mode only, drawing from
    the device generator of the port's ``random`` (``random.seed``)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        return ops.dropout(x, self._rate, axes=self._axes,
                           training=self.training)


class BatchNorm(Deferred, nn.Module):
    """Stock batch norm with running stats (the reference's ``BatchNorm``:
    axis 1, momentum 0.9, epsilon 1e-5).

    gamma and beta are parameters; ``scale=False`` (``center=False``)
    makes gamma (beta) a parameter without gradient, the reference's
    ``grad_req="null"``, and ``scale=False`` also normalizes with gamma
    taken as ones (``fix_gamma``).  running_mean and running_var are
    buffers, moved in training mode only (and not with
    ``use_global_stats``) by ``m * old + (1 - m) * batch``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 device=None):
        super().__init__()
        dev = context.resolve(device)
        self._axis = int(axis)
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._scale = bool(scale)
        self._use_global_stats = bool(use_global_stats)
        shape = (in_channels,) if in_channels else None
        self._param("gamma", shape, dev, fill=1.0, trainable=self._scale)
        self._param("beta", shape, dev, fill=0.0, trainable=bool(center))
        self._buffer("running_mean", shape, dev, 0.0)
        self._buffer("running_var", shape, dev, 1.0)

    def _infer_shapes(self, x):
        c = (x.shape[self._axis],)
        return dict.fromkeys(("gamma", "beta", "running_mean",
                              "running_var"), c)

    def forward(self, x):
        out, mean, var = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=self.training, output_mean_var=True)
        if self.training and not self._use_global_stats:
            rm, rv = ops.batch_norm_aux_update(
                self.running_mean, self.running_var, mean, var,
                self._momentum)
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)
        return out


class Flatten(nn.Module):
    def forward(self, x):
        return ops.flatten(x)


class HybridLambda(nn.Module):
    """``HybridLambda(function)``: ``function(F, x)`` with ``F`` the port's
    registered ops on tensors (``F.clip``, ``F.Concat``, ...)."""

    def __init__(self, function):
        super().__init__()
        self._func = function

    def forward(self, *args):
        return self._func(F, *args)
