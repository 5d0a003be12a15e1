"""Weight initializers (port of ``incubator_mxnet_tpu/initializer.py``:
``InitDesc``, the registry, ``Zero``, ``One``, ``Uniform``, ``Xavier``),
drawing from the port's ``random`` generator of the tensor's device
(``random.seed``) unless a ``torch.Generator`` is given.

As in the reference, a tensor's name picks what it gets: ``*weight``
goes to the initializer's weight rule, ``*bias``/``*beta``/
``*running_mean`` to zeros, ``*gamma``/``*running_var`` to ones.  An
initializer is called as the reference's, ``init(InitDesc(name),
ndarray)``, or on a tensor, ``init(name, tensor, generator)``; it
writes in place.  The same seed gives other numbers than JAX's
``jax.random``; tests that compare with the reference copy its weights
(``convert``).
"""
from __future__ import annotations

import math

import torch
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import is_lazy

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Uniform", "Xavier",
           "register", "registry_create", "create", "initialize"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def registry_create(name, **kwargs):
    """The initializer registered as ``name`` (``"xavier"``, ``"zeros"``)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError("Unknown initializer %r (known: %s)"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[key](**kwargs)


def create(init):
    """``init`` as an initializer: an instance passes, a name is looked
    up."""
    return registry_create(init) if isinstance(init, str) else init


class InitDesc(str):
    """A parameter's name and attributes, as an initializer receives
    them."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _tensor(arr):
    return arr._data if hasattr(arr, "_data") else arr


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)

    def __call__(self, desc, arr, generator=None):
        """Fill ``arr`` (an NDArray or a tensor) in place by the rule that
        the name ``desc`` selects."""
        name = str(desc)
        init = getattr(desc, "attrs", {}).get("__init__", "")
        t = _tensor(arr)
        if generator is None:
            from . import random

            generator = random.generator(t.device)
        with torch.no_grad():
            if init:
                registry_create(init)._init_weight(t, generator)
            elif name.endswith("weight"):
                self._init_weight(t, generator)
            elif name.endswith(("bias", "beta", "running_mean",
                                "moving_mean")):
                t.zero_()
            elif name.endswith(("gamma", "running_var", "moving_var")):
                t.fill_(1.0)
            else:
                self._init_weight(t, generator)

    def _init_weight(self, tensor, generator):
        raise NotImplementedError


@register
class Zero(Initializer):
    def _init_weight(self, tensor, generator):
        tensor.zero_()


@register
class One(Initializer):
    def _init_weight(self, tensor, generator):
        tensor.fill_(1.0)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    """Uniform in ``[-scale, scale]``: ``Parameter.initialize``'s
    default."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, tensor, generator):
        tensor.uniform_(-self.scale, self.scale, generator=generator)


@register
class Xavier(Initializer):
    """MXNet's Xavier with its defaults (``rnd_type="uniform"``,
    ``factor_type="avg"``, ``magnitude=3``): uniform in +-sqrt(magnitude
    / factor), factor the mean of fan-in and fan-out, fans counting the
    receptive field.  The other random types and factors wait for
    ROADMAP item 1d."""

    magnitude = 3.0

    def _init_weight(self, tensor, generator):
        shape = tensor.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        scale = math.sqrt(self.magnitude / ((fan_in + fan_out) / 2.0))
        tensor.uniform_(-scale, scale, generator=generator)


def initialize(net, init=None, generator=None):
    """Fill every parameter and buffer of ``net`` by the name rules:
    ``init`` (default ``Xavier()``) decides weights.  ``generator`` must
    live on the parameters' device (default: the port's ``random``
    generator of that device).  A tensor whose shape is still deferred
    is filled when its layer resolves it (``gluon.block.shape_init`` or
    the first forward), as the reference defers the initialization of
    such a parameter.  ``Block.initialize`` is the reference's form,
    where a parameter's own initializer comes first."""
    init = create(init) if init is not None else Xavier()
    for mod in net.modules():
        if isinstance(mod, LazyModuleMixin) and \
                mod.has_uninitialized_params():
            mod._pending_init = (init, generator)
        for p in getattr(mod, "_reg_params", {}).values():
            if p._tensor is not None and not is_lazy(p._tensor):
                p._initialized = True
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        if not is_lazy(t):
            init(name, t, generator)
    return net
