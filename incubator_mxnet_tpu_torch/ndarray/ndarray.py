"""NDArray: the imperative tensor (port of
``incubator_mxnet_tpu/ndarray/ndarray.py``).

An NDArray wraps one ``torch.Tensor`` on an explicit device; its
``context`` is that tensor's ``torch.device``.  Operators go through
``ops.registry.invoke``, which records them for autograd only inside
``autograd.record()``.  A write (``a += b``, ``a[i] = x``, ``out=``) swaps
the wrapped tensor for a new one, as the reference swaps its immutable
buffer, so a tensor that a recorded op saved is never changed under it.
``wait_to_read`` synchronises the array's stream; :func:`waitall` every
card.

Factories resolve ``ctx`` as every entry point of the port does:
``None`` is the default CUDA card, and a host without one raises unless
the caller passes ``ctx=cpu()``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.dlpack

from .. import autograd, context
from ..base import np_dtype, torch_dtype
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "stack", "waitall", "onehot_encode"]


def _recorded(fn):
    """``fn()``, a tensor expression outside ``invoke``, recorded only
    while ``autograd.record()`` is active (and detached otherwise, as
    ``invoke`` does)."""
    recording = autograd.is_recording()
    with torch.set_grad_enabled(recording):
        t = fn()
    return t if recording else t.detach()


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s; use "
                            "nd.array() for other sources" % type(data))
        self._data = data
        self._grad = None
        self._grad_req = "write"

    def _set_data(self, t):
        """Swap the wrapped tensor (the engine's write analogue).  A marked
        variable's tensor stays a leaf that requires a gradient."""
        if self._grad is not None:
            t = autograd._as_leaf(self, t)
        self._data = t

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> torch.device:
        return self._data.device

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self._data.item())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------- transfers
    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy().astype(np_dtype(t.dtype))
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def astorch(self) -> torch.Tensor:
        """The wrapped tensor (the reference's ``asjax``)."""
        return self._data

    def to_dlpack_for_read(self):
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    to_dlpack_for_write = to_dlpack_for_read

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def copy(self) -> "NDArray":
        return _reg.invoke("_copy", [self])

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        return NDArray(self._data.detach().to(context.resolve(other),
                                              copy=True))

    def as_in_context(self, ctx) -> "NDArray":
        dev = context.resolve(ctx)
        return NDArray(_recorded(lambda: self._data.to(dev)))

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return NDArray(_recorded(lambda: self._data.to(dt)))

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        g = NDArray(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [g], [grad_req])

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, opname, reverse=False):
        if isinstance(other, (int, float, bool, np.number)):
            # a fill on the device, not a copy from the host: a CUDA graph
            # can capture it
            other = NDArray(torch.full((), other, dtype=self._data.dtype,
                                       device=self._data.device))
        lhs, rhs = (other, self) if reverse else (self, other)
        return _reg.invoke(opname, [lhs, rhs])

    def __add__(self, o):
        return self._binop(o, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod")

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    def __matmul__(self, o):
        return _reg.invoke("dot", [self, o])

    def __neg__(self):
        return _reg.invoke("negative", [self])

    def __abs__(self):
        return _reg.invoke("abs", [self])

    def __eq__(self, o):  # noqa: D105 - MXNet semantics: elementwise
        if o is None:
            return False
        return self._binop(o, "broadcast_equal")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal")

    def __hash__(self):
        return id(self)

    # in place: swap the tensor, never write into it
    def __iadd__(self, o):
        self._set_data((self + o)._data)
        return self

    def __isub__(self, o):
        self._set_data((self - o)._data)
        return self

    def __imul__(self, o):
        self._set_data((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data((self / o)._data)
        return self

    # ------------------------------------------------------------- indexing
    @staticmethod
    def _index(k):
        """An NDArray key: bool masks stay bool, numeric keys index."""
        if not isinstance(k, NDArray):
            return k
        return k._data if k._data.dtype == torch.bool else k._data.long()

    def _key(self, key):
        if isinstance(key, tuple):
            return tuple(self._index(k) for k in key)
        return self._index(key)

    def __getitem__(self, key):
        key = self._key(key)
        parts = key if isinstance(key, tuple) else (key,)
        if all(isinstance(k, slice) for k in parts) and any(
                k.step is not None and k.step < 0 for k in parts):
            from ..ops.tensor import _take_slices

            full = list(parts) + [slice(None)] * (self.ndim - len(parts))
            return NDArray(_recorded(lambda: _take_slices(self._data, full)))
        return NDArray(_recorded(lambda: self._data[key]))

    def __setitem__(self, key, value):
        key = self._key(key)
        v = value._data if isinstance(value, NDArray) \
            else torch.as_tensor(value, device=self._data.device)
        v = v.to(device=self._data.device, dtype=self._data.dtype)

        def assigned():
            if key is Ellipsis or (isinstance(key, slice)
                                   and key == slice(None)):
                return torch.broadcast_to(v, self._data.shape).clone()
            new = self._data.clone()
            new[key] = v
            return new

        self._set_data(_recorded(assigned))

    def slice_assign(self, rhs, begin, end, step=None):
        self[tuple(slice(b, e, s) for b, e, s in
                   zip(begin, end, step or (None,) * len(begin)))] = rhs
        return self

    # ------------------------------------------------------------ op methods
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _reg.invoke("Reshape", [self], shape=shape,
                           reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return _reg.invoke("Reshape", [self], shape=other.shape)

    def transpose(self, axes=None):
        return _reg.invoke("transpose", [self], axes=axes)

    def flatten(self):
        return _reg.invoke("Flatten", [self])

    def expand_dims(self, axis):
        return _reg.invoke("expand_dims", [self], axis=axis)

    def squeeze(self, axis=None):
        return _reg.invoke("squeeze", [self], axis=axis)

    def swapaxes(self, dim1, dim2):
        return _reg.invoke("swapaxes", [self], dim1=dim1, dim2=dim2)

    def broadcast_to(self, shape):
        return _reg.invoke("broadcast_to", [self], shape=shape)

    def broadcast_like(self, other):
        return _reg.invoke("broadcast_like", [self, other])

    def slice(self, begin, end, step=None):  # noqa: A003
        return _reg.invoke("slice", [self], begin=begin, end=end,
                           step=step or ())

    def slice_axis(self, axis, begin, end):
        return _reg.invoke("slice_axis", [self], axis=axis, begin=begin,
                           end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _reg.invoke("take", [self, indices], axis=axis, mode=mode)

    def one_hot(self, depth, **kw):
        return _reg.invoke("one_hot", [self], depth=depth, **kw)

    def tile(self, reps):
        return _reg.invoke("tile", [self], reps=reps)

    def repeat(self, repeats, axis=None):
        return _reg.invoke("repeat", [self], repeats=repeats, axis=axis)

    def flip(self, axis):
        return _reg.invoke("reverse", [self], axis=axis)

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return _reg.invoke("pad", [self], mode=mode, pad_width=pad_width,
                           constant_value=constant_value)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _reg.invoke("SliceChannel", [self], num_outputs=num_outputs,
                           axis=axis, squeeze_axis=squeeze_axis)

    def clip(self, a_min, a_max):
        return _reg.invoke("clip", [self], a_min=a_min, a_max=a_max)

    def abs(self):  # noqa: A003
        return _reg.invoke("abs", [self])

    def sign(self):
        return _reg.invoke("sign", [self])

    def sqrt(self):
        return _reg.invoke("sqrt", [self])

    def square(self):
        return _reg.invoke("square", [self])

    def exp(self):
        return _reg.invoke("exp", [self])

    def log(self):
        return _reg.invoke("log", [self])

    def relu(self):
        return _reg.invoke("relu", [self])

    def sigmoid(self):
        return _reg.invoke("sigmoid", [self])

    def tanh(self):
        return _reg.invoke("tanh", [self])

    def softmax(self, axis=-1):
        return _reg.invoke("softmax", [self], axis=axis)

    def log_softmax(self, axis=-1):
        return _reg.invoke("log_softmax", [self], axis=axis)

    def sum(self, axis=None, keepdims=False, exclude=False):  # noqa: A003
        return _reg.invoke("sum", [self], axis=axis, keepdims=keepdims,
                           exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _reg.invoke("mean", [self], axis=axis, keepdims=keepdims,
                           exclude=exclude)

    def prod(self, axis=None, keepdims=False):
        return _reg.invoke("prod", [self], axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):  # noqa: A003
        return _reg.invoke("max", [self], axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):  # noqa: A003
        return _reg.invoke("min", [self], axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):  # noqa: A002
        return _reg.invoke("norm", [self], ord=ord, axis=axis,
                           keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _reg.invoke("argmax", [self], axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _reg.invoke("argmin", [self], axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return _reg.invoke("argsort", [self], axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _reg.invoke("sort", [self], axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _reg.invoke("topk", [self], axis=axis, k=k, ret_typ=ret_typ,
                           is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _reg.invoke("dot", [self, other], transpose_a=transpose_a,
                           transpose_b=transpose_b)

    def zeros_like(self):
        return _reg.invoke("zeros_like", [self])

    def ones_like(self):
        return _reg.invoke("ones_like", [self])

    def tostype(self, stype):
        if stype != "default":
            raise NotImplementedError(
                "sparse storage is not in the port yet (ROADMAP A13)")
        return self


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def _tensor_of(source, device):
    """``source`` (NDArray, tensor, numpy array, list or scalar) as a new
    tensor on ``device``.  Python floats become float32, as in the
    reference; numpy arrays keep their dtype."""
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        return source.detach().to(device, copy=True)
    a = np.asarray(source)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if t.dtype == torch.float64 and not isinstance(source, np.ndarray):
        t = t.float()
    return t.to(device)


def array(source_array, ctx=None, dtype=None) -> NDArray:
    t = _tensor_of(source_array, context.resolve(ctx))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t)


def zeros(shape, ctx=None, dtype="float32", **kw) -> NDArray:
    return _reg.invoke("_zeros", [], shape=shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype="float32", **kw) -> NDArray:
    return _reg.invoke("_ones", [], shape=shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype="float32", **kw) -> NDArray:
    return _reg.invoke("_full", [], shape=shape, value=val, ctx=ctx,
                       dtype=dtype)


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    return _reg.invoke("_arange", [], start=start, stop=stop, step=step,
                       repeat=repeat, ctx=ctx, dtype=dtype)


def concat(*args, dim=1):
    return _reg.invoke("Concat", list(args), dim=dim)


def stack(*args, axis=0):
    return _reg.invoke("stack", list(args), axis=axis)


def onehot_encode(indices, out):
    res = _reg.invoke("one_hot", [indices], depth=out.shape[1])
    out._set_data(res._data)
    return out


def waitall():
    """Wait for all work on every card (``Engine::WaitForAll``)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
