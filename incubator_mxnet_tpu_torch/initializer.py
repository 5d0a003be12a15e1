"""Weight initializers (port of ``incubator_mxnet_tpu/initializer.py``:
``Zero``, ``One``, ``Xavier``), drawing from an explicit
``torch.Generator``.

As in the reference, a tensor's name picks what it gets: ``*weight``
goes to the initializer's weight rule, ``*bias``/``*beta``/
``*running_mean`` to zeros, ``*gamma``/``*running_var`` to ones.  The
same seed gives other numbers than JAX's ``jax.random``; tests that
compare with the reference copy its weights (``convert.params_from_jax``).
"""
from __future__ import annotations

import math

import torch
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import is_lazy

__all__ = ["Initializer", "Zero", "One", "Xavier", "initialize"]


class Initializer:
    def __call__(self, name, tensor, generator=None):
        """Fill ``tensor`` in place by the rule its ``name`` selects."""
        with torch.no_grad():
            if name.endswith("weight"):
                self._init_weight(tensor, generator)
            elif name.endswith(("bias", "beta", "running_mean",
                                "moving_mean")):
                tensor.zero_()
            elif name.endswith(("gamma", "running_var", "moving_var")):
                tensor.fill_(1.0)
            else:
                self._init_weight(tensor, generator)

    def _init_weight(self, tensor, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, tensor, generator):
        tensor.zero_()


class One(Initializer):
    def _init_weight(self, tensor, generator):
        tensor.fill_(1.0)


class Xavier(Initializer):
    """MXNet's Xavier with its defaults (``rnd_type="uniform"``,
    ``factor_type="avg"``): uniform in +-sqrt(magnitude / factor), factor
    the mean of fan-in and fan-out, fans counting the receptive field.
    The other random types and factors wait for a later slice."""

    magnitude = 3.0

    def _init_weight(self, tensor, generator):
        shape = tensor.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        scale = math.sqrt(self.magnitude / ((fan_in + fan_out) / 2.0))
        tensor.uniform_(-scale, scale, generator=generator)


def initialize(net, init=None, generator=None):
    """Fill every parameter and buffer of ``net`` (``net.initialize``):
    ``init`` (default ``Xavier()``) decides weights, the name rules the
    rest.  ``generator`` must live on the parameters' device.  A tensor
    whose shape is still deferred is filled when its layer resolves it
    (``gluon.block.shape_init`` or the first forward), as the reference
    defers the initialization of such a parameter."""
    init = init if init is not None else Xavier()
    for mod in net.modules():
        if isinstance(mod, LazyModuleMixin) and \
                mod.has_uninitialized_params():
            mod._pending_init = (init, generator)
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        if not is_lazy(t):
            init(name, t, generator)
    return net
