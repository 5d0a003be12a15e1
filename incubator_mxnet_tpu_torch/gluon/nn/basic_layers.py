"""Basic layers (port of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``):
``Sequential`` and ``Lambda`` (``Block``s), ``HybridSequential``,
``Dense``, ``Dropout``, ``BatchNorm``, ``InstanceNorm``, ``LayerNorm``,
``GroupNorm``, ``Embedding``, ``Flatten`` and ``HybridLambda``, as
``HybridBlock``s.  Parameters are made inside
``name_scope()`` with the reference's names and initializers, on
``device`` (default: the enclosing ``context.device_scope``, else the
CUDA card); ``initialize`` fills them.  A width left at 0 is deferred to
the first input (``gluon.block``).  Each ``hybrid_forward`` is the
reference layer's: the symbolic body (``F = mx.sym``), and, where a layer
has no ``forward`` of its own, the tensor one too."""
from __future__ import annotations

import math

from ... import autograd, context
from ...ops import nn as ops
from ..block import F, Block, Deferred, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda"]


class _Stack:
    """The children in order: ``add``, ``len``, indexing and slicing (a
    slice is a new stack of the same type over the same blocks)."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            return type(self)(*layers[key])
        return layers[key]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Children run in order, on whatever they are given (NDArrays: each
    ``HybridBlock`` child records on the port's autograd).  Blocks given
    positionally are added."""

    def __init__(self, *blocks, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.add(*blocks)

    def forward(self, x):
        for child in self._modules.values():
            x = child(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Children run in order; a tuple output (a dual block exit) is handed
    to the next child as one value.  Blocks given positionally are
    added."""

    def __init__(self, *blocks, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.add(*blocks)

    def hybrid_forward(self, F, x):  # noqa: N803
        for child in self._modules.values():
            x = child(x)
        return x


class Dense(Deferred, HybridBlock):
    """Fully connected layer over the flattened input (over the last axis
    with ``flatten=False``): weight (units, in_units), bias (units,), an
    optional activation after it."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def _infer_shapes(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        return {"weight": (self._units, in_units)}

    def hybrid_forward(self, F, x, weight, bias=None):  # noqa: N803
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    """``Dropout(rate, axes)``: active in training mode only, drawing from
    the device generator of the port's ``random`` (``random.seed``)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return ops.dropout(x, float(self._rate), axes=tuple(self._axes),
                           training=self.training)

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(Deferred, HybridBlock):
    """Stock batch norm with running stats (the reference's ``BatchNorm``:
    axis 1, momentum 0.9, epsilon 1e-5).

    gamma and beta are parameters; ``scale=False`` (``center=False``)
    makes gamma (beta) a parameter without gradient, the reference's
    ``grad_req="null"``, and ``scale=False`` also normalizes with gamma
    taken as ones (``fix_gamma``).  running_mean and running_var are
    ``grad_req="null"`` Parameters held as buffers, moved in training
    mode only (and not with ``use_global_stats``) by
    ``m * old + (1 - m) * batch``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._axis = int(axis)
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._scale = bool(scale)
        self._use_global_stats = bool(use_global_stats)
        shape = (in_channels,)
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=shape,
                init=gamma_initializer, allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=shape,
                init=beta_initializer, allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=shape,
                init=running_mean_initializer, allow_deferred_init=True,
                buffer=True)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=shape,
                init=running_variance_initializer, allow_deferred_init=True,
                buffer=True)

    def _infer_shapes(self, x):
        c = (x.shape[self._axis],)
        return dict.fromkeys(("gamma", "beta", "running_mean",
                              "running_var"), c)

    def forward(self, x):
        # the registered op through F (contrib.amp's policy runs it in
        # float32), in this layer's mode, with the batch's mean and var
        with autograd._scope(training=self.training):
            out, mean, var = F.BatchNorm(
                x, self.gamma, self.beta, self.running_mean,
                self.running_var, eps=self._epsilon,
                momentum=self._momentum, fix_gamma=not self._scale,
                use_global_stats=self._use_global_stats,
                output_mean_var=True, axis=self._axis)
        if self.training and not self._use_global_stats:
            rm, rv = ops.batch_norm_aux_update(
                self.running_mean, self.running_var, mean, var,
                self._momentum)
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)
        return out

    def hybrid_forward(self, F, x, gamma, beta, running_mean,  # noqa: N803
                       running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis)


class _Norm(Deferred, HybridBlock):
    """gamma and beta of ``in_channels`` (0: from the input's ``axis``),
    ``scale=False`` (``center=False``) making gamma (beta) a parameter
    without gradient, as the reference's ``grad_req="null"``."""

    def __init__(self, axis, center, scale, beta_initializer,
                 gamma_initializer, in_channels, device, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _infer_shapes(self, x):
        return dict.fromkeys(("gamma", "beta"), (x.shape[self._axis],))


class InstanceNorm(_Norm):
    """Each channel of each sample normalized (``InstanceNorm``, channels
    on axis 1); gamma is not trained by default (``scale=False``)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, **kwargs):
        super().__init__(1, center, scale, beta_initializer,
                         gamma_initializer, in_channels, device, **kwargs)
        self._epsilon = epsilon

    def hybrid_forward(self, F, x, gamma, beta):  # noqa: N803
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(_Norm):
    """Each sample normalized over ``axis`` (default the last)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, **kwargs):
        super().__init__(axis, center, scale, beta_initializer,
                         gamma_initializer, in_channels, device, **kwargs)
        self._epsilon = epsilon

    def hybrid_forward(self, F, x, gamma, beta):  # noqa: N803
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class GroupNorm(_Norm):
    """Each of ``num_groups`` channel groups of each sample normalized;
    gamma and beta a channel."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, **kwargs):
        super().__init__(1, center, scale, beta_initializer,
                         gamma_initializer, in_channels, device, **kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon

    def hybrid_forward(self, F, x, gamma, beta):  # noqa: N803
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Rows of ``weight`` (input_dim, output_dim) at the input's indices
    (any dtype; the registered ``Embedding`` op, ``jnp.take``'s answers
    out of range).  ``sparse_grad`` is accepted and the gradient stays
    dense, as in the reference."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):  # noqa: N803
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Flatten(x)


class Lambda(Block):
    """``Lambda(function)``: ``function(*inputs)`` on what the block is
    given; a string names an ``mx.nd`` function (``"tanh"``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """``HybridLambda(function)``: ``function(F, x)`` with ``F`` the port's
    registered ops on tensors (``F.clip``, ``F.Concat``, ...); a string
    names the registered op to apply (``"tanh"``, ``"relu"``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            getattr(F, function)  # an unknown op name raises here
            self._func_name = function
        else:
            self._func_name = None
            self._func = function

    def hybrid_forward(self, F, *args):  # noqa: N803
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)
