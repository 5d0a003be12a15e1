"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (port of
``incubator_mxnet_tpu/gluon/parameter.py``).

A port ``Parameter`` owns one tensor: the ``torch.nn.Parameter`` (or,
for a running statistic, the buffer) that its layer registers with
PyTorch under the attribute name it was assigned to.  ``data()`` is an
NDArray over that same tensor, so a write through it (``set_data``, an
optimizer's update, ``data()[:] = x``) lands in the tensor that the
module computes with, and ``grad()`` is the NDArray that the port's
``autograd.backward`` fills.  The layer's attribute is the tensor (the
PyTorch idiom: ``layer.weight.shape``); the ``Parameter`` is reached
through ``block.params`` and ``collect_params()``.

A shape with a 0 in it is deferred: the tensor is PyTorch's
``UninitializedParameter``/``UninitializedBuffer`` until the layer sees
its first input (``gluon.shape_init``), and an initializer given before
then runs when the shape is known, as the reference's deferred
initialization does.
"""
from __future__ import annotations

import copy
import weakref
from collections import OrderedDict

import torch
from torch import nn
from torch.nn.parameter import is_lazy

from .. import context, initializer
from ..base import dtype_name, torch_dtype
from ..ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(Exception):
    """A parameter was read before its shape was known."""


class _ParamArray(NDArray):
    """The NDArray of a Parameter's tensor.  A write copies into the
    tensor instead of swapping it, so the module keeps computing with the
    written values (one tensor per parameter)."""

    __slots__ = ()

    def _set_data(self, t):
        with torch.no_grad():
            self._data.copy_(t)


def _constant_fill(init):
    """The value a constant initializer (``"zeros"``, ``"ones"``,
    ``Zero()``, ``One()``) writes, else None."""
    if isinstance(init, str):
        return {"zeros": 0.0, "zero": 0.0, "ones": 1.0,
                "one": 1.0}.get(init.lower())
    if isinstance(init, initializer.Zero):
        return 0.0
    if isinstance(init, initializer.One):
        return 1.0
    return None


class Parameter:
    """A named tensor of a block with its gradient and training options.

    ``grad_req`` is ``"write"``, ``"add"`` or ``"null"`` (no gradient: the
    tensor does not require one).  ``buffer=True`` (port only) holds the
    value as a torch buffer rather than an ``nn.Parameter``: BN's running
    statistics, which are ``grad_req="null"`` Parameters in the
    reference."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", buffer=False):
        if grad_req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (grad_req,))
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._stype = stype
        self._buffer = bool(buffer)
        self._var = None  # _ParamArray over the tensor
        self._initialized = False
        self._deferred_init = None  # (init, ctx, default_init)
        self._sym_var = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    def __deepcopy__(self, memo):
        # a copied net's tensor must lead autograd to the copy's array,
        # not (through the weak reference it carries) to this one's
        new = copy.copy(self)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            setattr(new, k, copy.deepcopy(v, memo))
        if new._var is not None:
            new._var._data._mx_variable = weakref.ref(new._var)
        return new

    # ------------------------------------------------------------ tensor
    @property
    def _tensor(self):
        return None if self._var is None else self._var._data

    def _ensure_tensor(self, device=None):
        """The tensor, made on ``device`` (None: the enclosing
        ``device_scope``, else the card) at first use."""
        if self._var is not None:
            return self._var._data
        dev = context.resolve(device)
        dt = torch_dtype(self.dtype)
        trainable = self._grad_req != "null"
        if self._shape_known():
            t = torch.empty(self._shape, device=dev, dtype=dt)
            fill = _constant_fill(self.init)
            if fill is not None:
                t.fill_(fill)
            if not self._buffer:
                t = nn.Parameter(t, requires_grad=trainable)
        elif self._buffer:
            t = nn.UninitializedBuffer(device=dev, dtype=dt)
        else:
            t = nn.UninitializedParameter(device=dev, dtype=dt,
                                          requires_grad=trainable)
        self._var = _ParamArray(t)
        t._mx_variable = weakref.ref(self._var)
        self._init_grad()
        return t

    def _init_grad(self):
        v = self._var
        v._grad_req = self._grad_req
        if self._grad_req == "null" or is_lazy(v._data):
            v._grad = None
        else:
            v._grad = NDArray(torch.zeros_like(v._data.detach()))

    def _materialized(self, name, pending=None):
        """The layer resolved this parameter's deferred shape: make its
        gradient and run the initializer that waited for it."""
        t = self._var._data
        self._shape = tuple(t.shape)
        if isinstance(t, nn.Parameter):
            t.requires_grad_(self._grad_req != "null")
        self._init_grad()
        if self._deferred_init is not None:
            self._finish_init(*self._deferred_init)
        elif pending is not None:
            init, generator = pending
            init(name, t, generator)
            self._initialized = True
        else:
            fill = _constant_fill(self.init)
            if fill is not None:
                with torch.no_grad():
                    t.fill_(fill)

    # ------------------------------------------------------------- shape
    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    @property
    def shape(self):
        t = self._tensor
        if t is not None and not is_lazy(t):
            return tuple(t.shape)
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        t = self._tensor
        if t is not None and not is_lazy(t):
            if tuple(new_shape) != tuple(t.shape):
                raise ValueError("%s has shape %s; cannot set %s"
                                 % (self.name, tuple(t.shape), new_shape))
            return
        self._shape = tuple(new_shape)

    # ---------------------------------------------------------- grad_req
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        self._grad_req = req
        t = self._tensor
        if t is not None:
            if isinstance(t, nn.Parameter) and not is_lazy(t):
                t.requires_grad_(req != "null")
            self._init_grad()

    # ------------------------------------------------------ initializing
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the tensor with ``init`` (else the parameter's own
        ``init``, else ``default_init``, else ``Uniform()``); on ``ctx``
        (moved there) when given.  A deferred shape defers this to the
        layer's first input."""
        if self._initialized and not force_reinit:
            return
        if default_init is None:
            default_init = initializer.Uniform()
        t = self._ensure_tensor(None if ctx is None else _one_ctx(ctx))
        if ctx is not None:
            self.reset_ctx(ctx)
        if is_lazy(t):
            if not self.allow_deferred_init:
                raise ValueError("Cannot initialize Parameter %s because it "
                                 "has invalid shape %s"
                                 % (self.name, self.shape))
            self._deferred_init = (init, ctx, default_init)
            return
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        init = initializer.create(init or self.init or default_init)
        init(initializer.InitDesc(self.name), self._var)
        self._deferred_init = None
        self._initialized = True
        self.zero_grad()

    # ------------------------------------------------------------ access
    def data(self, ctx=None) -> NDArray:
        t = self._ensure_tensor()
        if is_lazy(t):
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet: its shape is "
                "deferred to the first input (gluon.shape_init)" % self.name)
        return self._var

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None) -> NDArray:
        self.data()
        if self._var._grad is None:
            raise RuntimeError("Parameter %s does not have gradient "
                               "(grad_req='null')" % self.name)
        return self._var._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self._ensure_tensor().device]

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or numpy) into the tensor; a
        deferred shape takes the data's."""
        src = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(data)
        t = self._ensure_tensor()
        with torch.no_grad():
            if is_lazy(t):
                t.materialize(tuple(src.shape))
                self._shape = tuple(src.shape)
                self._init_grad()
            t.copy_(src.to(t.dtype))
        self._deferred_init = None
        self._initialized = True

    def zero_grad(self):
        g = None if self._var is None else self._var._grad
        if g is not None:
            g._data = torch.zeros_like(g._data)

    def reset_ctx(self, ctx):
        """Move the tensor (and gradient) to ``ctx``, keeping the tensor
        object the module holds."""
        dev = context.resolve(_one_ctx(ctx))
        t = self._ensure_tensor(dev)
        if not is_lazy(t) and t.device != dev:
            t.data = t.data.to(dev)
            self._init_grad()

    def cast(self, dtype):
        self.dtype = dtype_name(dtype)
        t = self._tensor
        if t is not None and not is_lazy(t):
            t.data = t.data.to(torch_dtype(dtype))
            self._init_grad()

    def var(self):
        """The variable symbol of this parameter (its name, shape and
        dtype), made once: what a ``HybridBlock`` called on symbols
        composes in its place."""
        if self._sym_var is None:
            from .. import symbol

            self._sym_var = symbol.var(self.name, shape=self.shape,
                                       dtype=self.dtype)
        return self._sym_var


def _one_ctx(ctx):
    return ctx[0] if isinstance(ctx, (list, tuple)) else ctx


class Constant(Parameter):
    """A parameter fixed at ``value`` (no gradient), held as a buffer."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = NDArray(torch.as_tensor(value))
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, buffer=True)

        class _CInit:
            def __call__(self, desc, arr):
                arr._set_data(value._data)

        self.init = _CInit()


class ParameterDict:
    """Ordered ``name -> Parameter`` with a prefix."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self.keys())

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``prefix + name``, made with ``kwargs`` if new (or
        taken from the shared dict).  A known parameter's zero dims take
        a given shape's."""
        full = self._prefix + name
        if full in self._params:
            param = self._params[full]
            shape = kwargs.get("shape")
            if shape is not None and param.shape is not None:
                shape = (shape,) if isinstance(shape, int) else tuple(shape)
                if len(shape) == len(param.shape):
                    shape = tuple(b if a in (0, -1, None) else a
                                  for a, b in zip(param.shape, shape))
                param.shape = shape
            return param
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
            self._params[full] = param
            return param
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def get_constant(self, name, value=None) -> Constant:
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        c = Constant(full, value)
        self._params[full] = c
        return c

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter: its own ``init`` first, then
        ``init`` (default ``Uniform()``)."""
        for p in self.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import save as nd_save

        arg = {}
        for name, p in self.items():
            n = name[len(strip_prefix):] if name.startswith(strip_prefix) \
                else name
            arg[n] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=context.cpu())
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise RuntimeError("Parameter %s missing in file %s"
                                   % (name, filename))
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise RuntimeError("Extra parameters in file: %s"
                                   % sorted(extra))
