"""Weight initializers (port of ``incubator_mxnet_tpu/initializer.py``:
``InitDesc``, the registry, ``Zero``, ``One``, ``Constant``, ``Uniform``,
``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear``,
``LSTMBias``, ``Mixed``, ``Load`` and ``FusedRNN``), drawing from the
port's ``random`` generator of the tensor's device (``random.seed``)
unless a ``torch.Generator`` is given (``Orthogonal`` too, where the
reference draws from numpy's global state).

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
import re

import numpy as np
import torch
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import is_lazy

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "FusedRNN", "register",
           "registry_create", "create", "initialize"]

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
class Constant(Initializer):
    """Every weight ``value``: a number, or an array (NDArray, tensor or
    numpy) of the weight's shape."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, tensor, generator):
        v = _tensor(self.value)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        if v.dim() == 0:
            tensor.fill_(v.item())
        else:
            tensor.copy_(v.to(tensor))


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
class Normal(Initializer):
    """Normal with mean 0 and deviation ``sigma``."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, tensor, generator):
        tensor.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor (of the SVD) of a
    ``(shape[0], prod(shape[1:]))`` draw, uniform in [-1, 1]
    (``rand_type="uniform"``) or standard normal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, tensor, generator):
        nout = tensor.shape[0]
        nin = math.prod(tensor.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float64,
                          device=tensor.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        tensor.copy_((self.scale * q).reshape(tensor.shape))


@register
class Xavier(Initializer):
    """MXNet's Xavier: uniform in +-sqrt(magnitude / factor)
    (``rnd_type="uniform"``) or normal with that deviation
    (``"gaussian"``); the factor is the mean of fan-in and fan-out
    (``factor_type="avg"``), fan-in (``"in"``) or fan-out (``"out"``),
    the fans counting the receptive field."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("Xavier rnd_type must be 'uniform' or "
                             "'gaussian', got %r" % (rnd_type,))
        if factor_type not in ("avg", "in", "out"):
            raise ValueError("Xavier factor_type must be 'avg', 'in' or "
                             "'out', got %r" % (factor_type,))
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, tensor, generator):
        shape = tensor.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            tensor.uniform_(-scale, scale, generator=generator)
        else:
            tensor.normal_(0.0, scale, generator=generator)


@register
class MSRAPrelu(Xavier):
    """Xavier, gaussian, with magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling filter of an (O, I, kh, kw) weight."""

    def _init_weight(self, tensor, generator):
        shape = tensor.shape
        n = math.prod(shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))) \
            .astype(np.float32)
        tensor.copy_(torch.from_numpy(weight.reshape(tuple(shape))))


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate's quarter (the second of i, f, c, o),
    ``forget_bias``.  As in the reference, it reaches a parameter named
    ``*bias`` only as that parameter's own ``__init__`` attribute: the
    name rule sends ``*bias`` to zeros first."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, tensor, generator):
        num_hidden = tensor.shape[0] // 4
        tensor.zero_()
        tensor[num_hidden:2 * num_hidden] = self.forget_bias


class Mixed:
    """The first initializer whose pattern matches the name (``re.match``)
    fills the parameter; no match raises."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, desc, arr, generator=None):
        for prog, init in self.map:
            if prog.match(str(desc)):
                init(desc, arr, generator)
                return
        raise ValueError("Parameter name %s did not match any pattern"
                         % desc)


class Load:
    """Parameters from a ``.params`` file or a ``{name: array}`` dict
    (``arg:``/``aux:`` prefixes stripped); a name not there goes to
    ``default_init``, or raises."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as _load
            from .context import cpu

            param = _load(param, ctx=cpu())
        self.param = {}
        for name, arr in dict(param).items():
            key = name[4:] if name.startswith(("arg:", "aux:")) else name
            self.param[key] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, desc, arr, generator=None):
        name = str(desc)
        t = _tensor(arr)
        if name in self.param:
            src = _tensor(self.param[name])
            src = src if isinstance(src, torch.Tensor) \
                else torch.as_tensor(np.asarray(src))
            if tuple(t.shape) != tuple(src.shape):
                raise ValueError(
                    "Parameter %s cannot be initialized from loading: "
                    "target %s vs loaded %s"
                    % (name, tuple(t.shape), tuple(src.shape)))
            with torch.no_grad():
                t.copy_(src.to(t))
            if self.verbose:
                import logging

                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    "Cannot initialize %s: not in the loaded params and "
                    "no default initializer provided" % name)
            self.default_init(desc, arr, generator)


@register
class FusedRNN(Initializer):
    """The fused ``RNN`` op's flat parameter vector: ``init`` (default
    ``Uniform(0.07)``) applied to each gate's slice of each layer's and
    direction's matrices and biases, under the names the reference's
    unpacked cell gives them (``l0_i2h_i_weight``, ``r1_h2h_f_bias``),
    and ``forget_bias`` on the LSTM's forget-gate biases.  The slices
    are views of the vector (the layout of ``ops.rnn.unpack_params``),
    so they are filled in place."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        init = create(init) if init is not None else None
        super().__init__(init=None if init is None else
                         type(init).__name__, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, tensor, generator):
        from .ops import rnn as rnn_ops

        h = self._num_hidden
        ndir = 2 if self._bidirectional else 1
        gates = rnn_ops.GATE_NAMES[self._mode]
        input_size = rnn_ops.infer_input_size(
            tensor.numel(), self._num_layers, h, self._mode, ndir)
        layers = rnn_ops.unpack_params(tensor, self._num_layers, input_size,
                                       h, self._mode, ndir)
        init = self._init if self._init is not None else Uniform(0.07)
        named = []
        for i, (wx, wh, bx, bh) in enumerate(layers):
            p = "%s%d_" % ("lr"[i % ndir], i // ndir)
            named += [(p + "i2h_weight", wx), (p + "h2h_weight", wh),
                      (p + "i2h_bias", bx), (p + "h2h_bias", bh)]
        for name, arr in named:
            for g, gate in enumerate(gates):
                init(InitDesc(name.replace("_weight", gate + "_weight")
                              .replace("_bias", gate + "_bias")),
                     arr[g * h:(g + 1) * h], generator)
            if self._mode == "lstm" and name.endswith("bias"):
                f = gates.index("_f")
                arr[f * h:(f + 1) * h] = self._forget_bias


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
