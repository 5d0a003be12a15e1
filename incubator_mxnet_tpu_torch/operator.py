"""``mx.operator``: custom operators written in Python (port of
``incubator_mxnet_tpu/operator.py``).

A user subclasses :class:`CustomOpProp` (the op's signature: its
arguments, outputs, shapes and types) and :class:`CustomOp` (its
``forward`` and ``backward``), registers the prop under a name with
:func:`register`, and calls the ``Custom`` op with ``op_type=`` that
name: ``mx.nd.Custom(x, op_type="sqr")`` or ``mx.sym.Custom(...)``.

The reference runs the callbacks on the host through
``jax.pure_callback``.  Here ``Custom`` is a ``torch.autograd.Function``:
its forward creates an operator and calls ``forward`` with the inputs
and zero-filled outputs as NDArrays on the inputs' device; its backward
creates another operator, as the reference does, and calls ``backward``
with ``out_grad``, ``in_data``, ``out_data`` and zeroed ``in_grad``.
Written in ``nd`` ops, a callback runs on the card and reads nothing
back.  The arrays it is given also answer the host views of the
reference's: ``np.asarray``, ``asnumpy``, indexing and slice assignment
from an NDArray or from numpy.

Shapes and types come from ``infer_shape``/``infer_type``: on ``meta``
tensors (the symbolic shape inference) the op answers from them and
never runs the callbacks.  The registry's reflection (``list_ops``,
``op_info``, ``op_doc``) is re-exported under the reference's names.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import autograd, context
from .base import np_dtype, torch_dtype
from .ndarray import NDArray
from .ops.registry import list_ops as get_all_op_names  # noqa: F401
from .ops.registry import op_doc as get_op_doc  # noqa: F401
from .ops.registry import op_info as get_op_info  # noqa: F401
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "NDArrayOp", "get_op_info", "get_op_doc", "get_all_op_names"]

_CUSTOM_PROPS: Dict[str, type] = {}


class CustomOp:
    """The base class of a custom op's computation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says: nothing for
        ``null``, a copy for ``write``/``inplace``, a sum for ``add``."""
        if req in ("null", 0):
            return
        if req in ("write", "inplace", 1, 2):
            dst[:] = src
        elif req in ("add", 3):
            dst[:] = dst + src


class CustomOpProp:
    """The base class of a custom op's signature."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a :class:`CustomOpProp` subclass as ``op_type=reg_name``."""
    def do_register(prop_cls):
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered():
    return dict(_CUSTOM_PROPS)


def _make_prop(op_type, attrs):
    """The prop of ``op_type``, built from the op's attributes as strings
    (as the reference passes them)."""
    if op_type not in _CUSTOM_PROPS:
        raise ValueError("custom op type %r not registered via "
                         "mx.operator.register" % op_type)
    return _CUSTOM_PROPS[op_type](**{k: v if isinstance(v, str) else str(v)
                                     for k, v in attrs.items()})


def custom_num_outputs(op_type, attrs):
    """The output count of a ``Custom`` node (symbolic composition)."""
    return len(_make_prop(op_type, attrs).list_outputs())


class _Array(NDArray):
    """An NDArray handed to a callback: also a host array for numpy."""

    __slots__ = ()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a if dtype is None else a.astype(dtype)


def _arrays(tensors):
    return [_Array(t.detach()) for t in tensors]


class _Signature:
    """A ``Custom`` call's prop with its inferred shapes and types."""

    def __init__(self, op_type, attrs, tensors):
        self.prop = _make_prop(op_type, attrs)
        self.in_shapes = [tuple(t.shape) for t in tensors]
        in_types = [np_dtype(t.dtype) for t in tensors] \
            or [np.dtype("float32")]
        shapes = self.prop.infer_shape([list(s) for s in self.in_shapes])
        types = self.prop.infer_type(list(in_types))
        self.out_shapes = [tuple(int(d) for d in s) for s in shapes[1]]
        self.out_types = [torch_dtype(np.dtype(t)) for t in types[1]]
        self.in_types = [np.dtype(t) for t in types[0]]

    def operator(self):
        return self.prop.create_operator(None, self.in_shapes, self.in_types)


class _CustomFunction(torch.autograd.Function):
    """``Custom`` as an autograd node: forward and backward call a fresh
    operator each, on the tensors' device."""

    @staticmethod
    def forward(ctx, sig, *xs):
        # with no input, the enclosing device scope's device, else the card
        dev = xs[0].device if xs else context.resolve(None)
        outs = [_Array(torch.zeros(s, dtype=t, device=dev))
                for s, t in zip(sig.out_shapes, sig.out_types)]
        with autograd.pause(train_mode=True):
            sig.operator().forward(is_train=True, req=["write"] * len(outs),
                                   in_data=_arrays(xs), out_data=outs, aux=[])
        res = tuple(o._data.detach() for o in outs)
        ctx.sig = sig
        ctx.save_for_backward(*xs, *res)
        ctx.n_in = len(xs)
        return res

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grad = [_Array(torch.zeros_like(x)) for x in xs]
        with autograd.pause(train_mode=True):
            ctx.sig.operator().backward(
                req=["write"] * len(xs), out_grad=_arrays(grads),
                in_data=_arrays(xs), out_data=_arrays(outs), in_grad=in_grad,
                aux=[])
        return (None,) + tuple(g._data if need else None
                               for g, need in zip(in_grad,
                                                  ctx.needs_input_grad[1:]))


@_register_op("Custom", num_inputs=None)
def _custom(*arrays, op_type=None, **attrs):
    """The ``Custom`` op: the registered ``op_type``'s ``forward``, with
    its ``backward`` as the gradient; on ``meta`` tensors, empty outputs
    of the inferred shapes and types."""
    sig = _Signature(op_type, attrs, arrays)
    if any(a.device.type == "meta" for a in arrays):
        outs = tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in zip(sig.out_shapes, sig.out_types))
    else:
        outs = _CustomFunction.apply(sig, *arrays)
    return outs[0] if len(outs) == 1 else outs


class NDArrayOp:
    """The reference's deprecated form: use :class:`CustomOp`."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("NDArrayOp is deprecated; use CustomOp")
