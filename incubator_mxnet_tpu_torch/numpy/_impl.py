"""The functions of ``mx.np`` in torch ops, with NumPy's semantics and
the reference's dtypes (``jax.numpy`` with 64-bit types on).

Each takes tensors where NumPy takes arrays (the dispatcher in
``__init__`` unwraps NDArrays and wraps what comes back).  Lists, tuples,
numpy arrays and Python numbers become tensors on the device of the
call (:func:`_dev`): ``jnp.asarray``'s dtypes (Python floats float64,
ints int64), Python scalars weak where they meet an array
(``base.np_result_type``).  The notes the reference's behaviour needs:

* ``median`` averages the two middle values (``torch.median`` takes the
  lower one); ``mod``/``remainder`` are floor modulo, ``fmod``
  truncated; ``split`` takes a count of equal sections or indices;
  ``unique`` is sorted; ``nonzero`` returns a tuple; ``sort`` and
  ``argsort`` are stable, -0.0 equal to 0.0 and NaN last, as
  ``jnp.argsort`` in JAX 0.9;
* integers and booleans through an inexact function become float32
  (int64: float64), their sums and products int64; ``rint`` of an
  integer is float64;
* ``isclose``/``allclose`` keep NumPy's defaults (rtol 1e-5, atol
  1e-8).
"""
from __future__ import annotations

import builtins
import math
import threading

import numpy as _onp
import torch
import torch.nn.functional as F

from .. import context
from ..base import (np_dtype, np_inexact, np_promote_types, np_result_type,
                    torch_dtype)
from ..ops import npi

_STATE = threading.local()


def _dev():
    """The device of the current call: its first array's, else the
    enclosing ``device_scope``'s or the card."""
    dev = getattr(_STATE, "device", None)
    return dev if dev is not None else context.resolve(None)


_DEFAULT = {bool: torch.bool, int: torch.int64, float: torch.float64,
            complex: torch.complex128}


def _arr(x, dtype=None):
    """``jnp.asarray(x, dtype)`` as a tensor on the call's device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(torch_dtype(dtype))
    if type(x) in _DEFAULT:
        t = torch.tensor(x, dtype=_DEFAULT[type(x)], device=_dev())
    elif isinstance(x, (list, tuple)) and any(
            isinstance(v, torch.Tensor) for v in x):
        parts = [_arr(v) for v in x]
        dt = np_result_type(*parts)
        t = torch.stack([p.to(dt) for p in parts])
    else:
        a = _onp.asarray(x)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(_onp.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(_onp.array(a))
        t = t.to(_dev())
    return t if dtype is None else t.to(torch_dtype(dtype))


def _strong(x):
    """``x`` for type promotion: Python scalars stay weak."""
    return x if type(x) in _DEFAULT or isinstance(x, torch.Tensor) \
        else _arr(x)


def _as(x, dtype):
    return x.to(dtype) if isinstance(x, torch.Tensor) else _arr(x, dtype)


def _operands(*xs, inexact=False):
    xs = [_strong(x) for x in xs]
    dt = np_result_type(*xs)
    if inexact:
        dt = np_inexact(dt)
    return [_as(x, dt) for x in xs]


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(axis) % max(ndim, 1),)


_sum_dtype = npi._sum_dtype


# -- elementwise -------------------------------------------------------------

def _binary(tfn, inexact=False):
    """An elementwise function of two operands in their promoted type (its
    inexact type where ``inexact``)."""
    def f(x1, x2):
        return tfn(*_operands(x1, x2, inexact=inexact))
    return f


def _unary(tfn, inexact=False):
    def f(x):
        x = _arr(x)
        return tfn(x.to(np_inexact(x.dtype)) if inexact else x)
    return f


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _abs(x):
    return x.clone() if x.dtype == torch.bool else torch.abs(x)


def _square(x):
    return x * x


def _integral(tfn):
    """floor/ceil/trunc/fix: integers pass unchanged."""
    def f(x):
        x = _arr(x)
        return tfn(x) if x.is_floating_point() else x.clone()
    return f


def rint(x):
    x = _arr(x)
    return torch.round(x) if x.is_floating_point() \
        else x.to(torch.float64)


def _round(a, decimals=0, out=None):
    a = _arr(a)
    return npi._round_even(a, decimals) if a.is_floating_point() \
        else a.clone()


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _arr(x)
    return npi._nan_to_num(x, nan, posinf, neginf) if x.is_floating_point() \
        else x.clone()


def heaviside(x1, x2):
    """0 below 0, 1 above, ``x2`` at 0 (differentiable in ``x2``, as
    ``jnp.heaviside``'s nested ``where``)."""
    a, b = _operands(x1, x2, inexact=True)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.where(a < 0, zero, torch.where(a > 0, one, b))


def clip(a, a_min=None, a_max=None, out=None, **kw):
    a_min = kw.get("min", a_min)
    a_max = kw.get("max", a_max)
    xs = _operands(a, *[v for v in (a_min, a_max) if v is not None])
    x, rest = xs[0], list(xs[1:])
    lo = rest.pop(0) if a_min is not None else None
    hi = rest.pop(0) if a_max is not None else None
    if lo is not None:
        x = torch.maximum(x, lo)
    if hi is not None:
        x = torch.minimum(x, hi)
    return x


def divmod_(x1, x2):
    a, b = _operands(x1, x2)
    return torch.floor_divide(a, b), torch.remainder(a, b)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _operands(a, b)
    if not (a.is_floating_point() or a.is_complex()):
        return a == b
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(isclose(a, b, rtol, atol, equal_nan))


def array_equal(a1, a2, equal_nan=False):
    a1, a2 = _arr(a1), _arr(a2)
    if a1.shape != a2.shape:
        return torch.tensor(False, device=a1.device)
    a1, a2 = _operands(a1, a2)
    eq = a1 == a2
    if equal_nan and a1.is_floating_point():
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return torch.all(eq)


def array_equiv(a1, a2):
    a1, a2 = _arr(a1), _arr(a2)
    try:
        shape = torch.broadcast_shapes(a1.shape, a2.shape)
    except RuntimeError:
        return torch.tensor(False, device=a1.device)
    a1, a2 = _operands(a1, a2)
    return torch.all(a1.broadcast_to(shape) == a2.broadcast_to(shape))


def iscomplex(x):
    x = _arr(x)
    return (x.imag != 0) if x.is_complex() else torch.zeros_like(
        x, dtype=torch.bool)


def isreal(x):
    x = _arr(x)
    return (x.imag == 0) if x.is_complex() else torch.ones_like(
        x, dtype=torch.bool)


def _imag(x):
    x = _arr(x)
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _real(x):
    x = _arr(x)
    return x.real if x.is_complex() else x.clone()


def _conj(x):
    x = _arr(x)
    return torch.conj(x).resolve_conj() if x.is_complex() else x.clone()


# -- reductions --------------------------------------------------------------

def _reduce(x, axis, keepdims, fn):
    """``fn(x, dim, keepdim)`` over each axis of ``axis`` in turn, from
    the last (for ops without a multi-axis form)."""
    x = _arr(x)
    if x.ndim == 0:
        return fn(x.reshape(1), 0, False)
    for ax in sorted(_axes(axis, x.ndim), reverse=True):
        x = fn(x, ax, bool(keepdims))
    return x


def sum_(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None):
    a = _arr(a)
    dt = torch_dtype(dtype) if dtype is not None else _sum_dtype(a)
    out = torch.sum(a.to(dt), dim=_axes(axis, a.ndim), keepdim=bool(keepdims))
    return out if initial is None else out + initial


def prod(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None):
    a = _arr(a)
    dt = torch_dtype(dtype) if dtype is not None else _sum_dtype(a)
    out = _reduce(a.to(dt), axis, keepdims,
                  lambda x, d, k: torch.prod(x, dim=d, keepdim=k))
    return out if initial is None else out * initial


def mean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):
    a = _arr(a)
    dt = torch_dtype(dtype) if dtype is not None else np_inexact(a.dtype)
    return torch.mean(a.to(dt), dim=_axes(axis, a.ndim),
                      keepdim=bool(keepdims))


def var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, **kw):
    return npi._var(_arr(a), axis, ddof, keepdims)


def std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, **kw):
    return npi._std(_arr(a), axis, ddof, keepdims)


def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    """The mean of the two middle values (the middle one twice for an
    odd count), as NumPy and ``jnp.median``."""
    a = _arr(a)
    a = a.to(np_inexact(a.dtype))
    if axis is None:
        x, ax = a.reshape(-1), 0
    else:
        x, ax = a, int(axis) % a.ndim
    n = x.shape[ax]
    s = torch.sort(x, dim=ax, stable=True).values
    lo = s.narrow(ax, (n - 1) // 2, 1)
    hi = s.narrow(ax, n // 2, 1)
    out = ((lo + hi) / 2).squeeze(ax)
    if keepdims:
        if axis is None:
            return out.reshape((1,) * a.ndim)
        return out.unsqueeze(ax)
    return out


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    return npi._average(_arr(a), None if weights is None else _arr(weights),
                        axis, returned)


def _amax(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _arr(a)
    return torch.amax(a, dim=_axes(axis, a.ndim), keepdim=bool(keepdims))


def _amin(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _arr(a)
    return torch.amin(a, dim=_axes(axis, a.ndim), keepdim=bool(keepdims))


def ptp(a, axis=None, out=None, keepdims=False):
    return _amax(a, axis, keepdims=keepdims) - _amin(a, axis,
                                                     keepdims=keepdims)


def nansum(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
    a = _arr(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return sum_(a, axis, dtype, keepdims=keepdims)


def nanprod(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
    a = _arr(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    return prod(a, axis, dtype, keepdims=keepdims)


def nanmean(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
    a = _arr(a)
    a = a.to(np_inexact(a.dtype))
    return torch.nanmean(a, dim=_axes(axis, a.ndim), keepdim=bool(keepdims))


def nanmax(a, axis=None, out=None, keepdims=False, **kw):
    a = _arr(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.full_like(a, -math.inf), a)
    return _amax(a, axis, keepdims=keepdims)


def nanmin(a, axis=None, out=None, keepdims=False, **kw):
    a = _arr(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.full_like(a, math.inf), a)
    return _amin(a, axis, keepdims=keepdims)


def _cum(tfn):
    def f(a, axis=None, dtype=None, out=None):
        a = _arr(a)
        if axis is None:
            a, axis = a.reshape(-1), 0
        dt = torch_dtype(dtype) if dtype is not None else (
            torch.int64 if a.dtype == torch.bool else a.dtype)
        return tfn(a.to(dt), dim=int(axis)).to(dt)
    return f


def argmax(a, axis=None, out=None, keepdims=False):
    a = _arr(a)
    if axis is None:
        out = torch.argmax(a.reshape(-1))
        return out.reshape((1,) * a.ndim) if keepdims else out
    return torch.argmax(a, dim=int(axis), keepdim=bool(keepdims))


def argmin(a, axis=None, out=None, keepdims=False):
    a = _arr(a)
    if axis is None:
        out = torch.argmin(a.reshape(-1))
        return out.reshape((1,) * a.ndim) if keepdims else out
    return torch.argmin(a, dim=int(axis), keepdim=bool(keepdims))


def count_nonzero(a, axis=None, keepdims=False):
    a = _arr(a)
    return torch.sum(a != 0, dim=_axes(axis, a.ndim), keepdim=bool(keepdims),
                     dtype=torch.int64)


def _logical_reduce(tfn):
    def f(a, axis=None, out=None, keepdims=False, where=None):
        return _reduce(_arr(a).to(torch.bool), axis, keepdims,
                       lambda x, d, k: tfn(x, dim=d, keepdim=k))
    return f


# -- products ----------------------------------------------------------------

def matmul(a, b, out=None):
    return torch.matmul(*_operands(a, b))


def dot(a, b, out=None):
    a, b = _operands(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def vdot(a, b):
    a, b = _operands(a, b)
    a = torch.conj(a).resolve_conj() if a.is_complex() else a
    return torch.sum(a.reshape(-1) * b.reshape(-1))


def inner(a, b):
    a, b = _operands(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 1]))


def outer(a, b, out=None):
    a, b = _operands(a, b)
    return a.reshape(-1, 1) * b.reshape(1, -1)


def tensordot(a, b, axes=2):
    a, b = _operands(a, b)
    if isinstance(axes, (tuple, list)):
        axes = [list(x) if isinstance(x, (tuple, list)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


def einsum(subscripts, *operands, **kw):
    return torch.einsum(subscripts, *_operands(*operands))


def kron(a, b):
    return torch.kron(*_operands(a, b))


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _operands(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a = torch.movedim(a, axisa, -1)
    b = torch.movedim(b, axisb, -1)
    if a.shape[-1] == 2:
        a = F.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = F.pad(b, (0, 1))
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.linalg.cross(a.broadcast_to(shape), b.broadcast_to(shape),
                             dim=-1)
    return torch.movedim(out, -1, axisc)


# -- shapes and joins --------------------------------------------------------

def reshape(a, shape=None, order="C", newshape=None):
    a = _arr(a)
    shape = newshape if shape is None else shape
    if isinstance(shape, int):
        shape = (shape,)
    return torch.reshape(a, tuple(shape))


def ravel(a, order="C"):
    return _arr(a).reshape(-1)


def transpose(a, axes=None):
    a = _arr(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    return a.permute(*axes)


def swapaxes(a, axis1, axis2):
    return torch.swapaxes(_arr(a), int(axis1), int(axis2))


def moveaxis(a, source, destination):
    return npi._moveaxis(_arr(a), source, destination)


def rollaxis(a, axis, start=0):
    a = _arr(a)
    n = a.ndim
    axis, start = int(axis) % n, int(start)
    start = start + n if start < 0 else start
    if start > axis:
        start -= 1
    return torch.movedim(a, axis, start)


def _seq(arrays):
    return _operands(*arrays)


def concatenate(arrays, axis=0, out=None, dtype=None):
    return npi._concatenate(*_seq(arrays), axis=axis)


def stack(arrays, axis=0, out=None, dtype=None):
    return torch.stack(_seq(arrays), dim=int(axis))


def vstack(tup, dtype=None):
    return npi._vstack(*_seq(tup))


def hstack(tup, dtype=None):
    return torch.hstack(_seq(tup))


def dstack(tup, dtype=None):
    return npi._dstack(*_seq(tup))


def column_stack(tup):
    return npi._column_stack(*_seq(tup))


def split(ary, indices_or_sections, axis=0):
    """Equal sections (a count that must divide the axis) or the pieces
    between the given indices (NumPy's ``split``; not torch's sizes)."""
    ary = _arr(ary)
    if isinstance(indices_or_sections, int):
        n = ary.shape[int(axis)]
        if n % indices_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
    return array_split(ary, indices_or_sections, axis)


def array_split(ary, indices_or_sections, axis=0):
    ary = _arr(ary)
    spec = indices_or_sections
    if not isinstance(spec, int):
        spec = [int(i) for i in spec]
    return list(torch.tensor_split(ary, spec, dim=int(axis)))


def hsplit(ary, indices_or_sections):
    ary = _arr(ary)
    return split(ary, indices_or_sections, axis=1 if ary.ndim > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=2)


def squeeze(a, axis=None):
    a = _arr(a)
    if axis is None:
        return torch.squeeze(a)
    return torch.squeeze(a, dim=_axes(axis, a.ndim))


def expand_dims(a, axis):
    a = _arr(a)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = a.ndim + len(axes)
    for ax in sorted(int(x) % n for x in axes):
        a = a.unsqueeze(ax)
    return a


def broadcast_to(array, shape):
    if isinstance(shape, int):
        shape = (shape,)
    return _arr(array).broadcast_to(tuple(shape))


def repeat(a, repeats, axis=None, total_repeat_length=None):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    if not isinstance(repeats, int):
        repeats = _arr(repeats).to(a.device)
    return torch.repeat_interleave(a, repeats, dim=int(axis))


def tile(A, reps):  # noqa: N803 - numpy name
    if isinstance(reps, int):
        reps = (reps,)
    return torch.tile(_arr(A), tuple(reps))


def flip(m, axis=None):
    m = _arr(m)
    return torch.flip(m, dims=_axes(axis, m.ndim))


def fliplr(m):
    return torch.flip(_arr(m), dims=(1,))


def flipud(m):
    return torch.flip(_arr(m), dims=(0,))


def roll(a, shift, axis=None):
    return npi._roll(_arr(a), shift, axis)


def rot90(m, k=1, axes=(0, 1)):
    return npi._rot90(_arr(m), k, axes)


def _atleast(tfn):
    def f(*arys):
        outs = [tfn(_arr(a)) for a in arys]
        return outs[0] if len(outs) == 1 else outs
    return f


# -- indexing ----------------------------------------------------------------

def nonzero(a):
    a = _arr(a)
    if a.ndim == 0:
        a = a.reshape(1)
    return tuple(torch.nonzero(a, as_tuple=True))


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    cond = _arr(condition).to(torch.bool)
    x, y = _operands(x, y)
    return torch.where(cond, x, y)


def _wrap_index(idx, n):
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def take(a, indices, axis=None, out=None, mode=None, **kw):
    a = _arr(a)
    idx = _arr(indices).to(a.device)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis = int(axis) % a.ndim
    flat = _wrap_index(idx.reshape(-1), a.shape[axis])
    out = torch.index_select(a, axis, flat)
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def take_along_axis(arr, indices, axis, **kw):
    arr = _arr(arr)
    idx = _arr(indices).to(arr.device)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis = int(axis) % arr.ndim
    return torch.take_along_dim(arr, _wrap_index(idx, arr.shape[axis]),
                                dim=axis)


def compress(condition, a, axis=None, out=None):
    a = _arr(a)
    cond = _arr(condition).to(torch.bool).reshape(-1)
    if axis is None:
        a, axis = a.reshape(-1), 0
    cond = cond[:a.shape[int(axis)]]
    return torch.index_select(a, int(axis), torch.nonzero(cond).reshape(-1))


def extract(condition, arr, **kw):
    arr = _arr(arr)
    cond = _arr(condition).to(torch.bool).reshape(-1)
    return arr.reshape(-1)[torch.nonzero(cond).reshape(-1)]


def diag(v, k=0):
    return torch.diag(_arr(v), int(k))


def diagonal(a, offset=0, axis1=0, axis2=1):
    return npi._diagonal(_arr(a), offset, axis1, axis2)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    a = _arr(a)
    d = torch.diagonal(a, int(offset), int(axis1), int(axis2))
    dt = torch_dtype(dtype) if dtype is not None else _sum_dtype(a)
    return d.sum(-1, dtype=dt)


def tril(m, k=0):
    return torch.tril(_arr(m), int(k))


def triu(m, k=0):
    return torch.triu(_arr(m), int(k))


def _pad_index(n, before, after, mode, dev):
    i = torch.arange(-before, n + after, device=dev)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = 2 * (n - 1)
        i = torch.remainder(i, p)
        return torch.where(i > n - 1, p - i, i)
    if mode == "symmetric":
        p = 2 * n
        i = torch.remainder(i, p)
        return torch.where(i > n - 1, p - 1 - i, i)
    raise NotImplementedError("mx.np.pad mode %r" % (mode,))


def pad(array, pad_width, mode="constant", **kwargs):
    """NumPy's ``pad`` in modes constant, edge, wrap, reflect and
    symmetric (the last three by index arithmetic on each axis)."""
    a = _arr(array)
    pw = _onp.broadcast_to(_onp.asarray(pad_width, dtype=_onp.int64),
                           (a.ndim, 2))
    if mode == "constant":
        value = kwargs.get("constant_values", 0)
        flat = []
        for before, after in reversed(pw.tolist()):
            flat += [before, after]
        if _onp.ndim(value):
            raise NotImplementedError("mx.np.pad with per-axis constants")
        return F.pad(a, flat, value=value)
    for ax, (before, after) in enumerate(pw.tolist()):
        if before or after:
            a = torch.index_select(a, ax, _pad_index(
                a.shape[ax], before, after, mode, a.device))
    return a


def delete(arr, obj, axis=None, **kw):
    arr = _arr(arr)
    if isinstance(obj, slice):
        return npi._delete(arr, None, obj.start or 0, obj.stop, obj.step,
                           axis)
    if isinstance(obj, torch.Tensor):
        obj = obj.tolist()
    return npi._delete(arr, obj, axis=axis)


def insert(arr, obj, values, axis=None):
    """NumPy's ``insert``: ``values`` before the index ``obj`` (a slab
    as wide as ``values``) or one entry before each index of a
    sequence."""
    arr = _arr(arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis = int(axis) % arr.ndim
    n = arr.shape[axis]
    vals = _arr(values).to(arr.device, arr.dtype)
    if isinstance(obj, int):
        idx = obj + n if obj < 0 else obj
        while vals.ndim < arr.ndim:
            vals = vals.unsqueeze(0)
        vals = torch.movedim(vals, 0, axis) if vals.ndim == arr.ndim \
            and arr.ndim > 1 else vals
        shape = list(arr.shape)
        shape[axis] = vals.shape[axis]
        vals = vals.broadcast_to(shape)
        return torch.cat([arr.narrow(axis, 0, idx), vals,
                          arr.narrow(axis, idx, n - idx)], dim=axis)
    idx = torch.as_tensor(list(obj), dtype=torch.int64, device=arr.device)
    idx = torch.where(idx < 0, idx + n, idx)
    order = torch.argsort(idx, stable=True)
    pos = idx.clone()
    pos[order] = idx[order] + torch.arange(len(idx), device=arr.device)
    total = n + len(idx)
    keep = torch.ones(total, dtype=torch.bool, device=arr.device)
    keep[pos] = False
    shape = list(arr.shape)
    shape[axis] = len(idx)
    out_shape = list(arr.shape)
    out_shape[axis] = total
    out = torch.empty(out_shape, dtype=arr.dtype, device=arr.device)
    out = out.index_copy(axis, torch.nonzero(keep).reshape(-1), arr)
    return out.index_copy(axis, pos, vals.broadcast_to(shape))


def append(arr, values, axis=None):
    arr, values = _operands(arr, values)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], dim=int(axis))


def select(condlist, choicelist, default=0):
    xs = _operands(*choicelist, default)
    out = xs[-1]
    for c, x in reversed(list(zip(condlist, xs[:-1]))):
        out = torch.where(_arr(c).to(torch.bool), x, out)
    return out


def diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _arr(a)
    kw = {}
    if prepend is not None:
        kw["prepend"] = _arr(prepend).to(a.dtype).broadcast_to(
            _edge_shape(a, axis))
    if append is not None:
        kw["append"] = _arr(append).to(a.dtype).broadcast_to(
            _edge_shape(a, axis))
    return torch.diff(a, n=int(n), dim=int(axis), **kw)


def _edge_shape(a, axis):
    shape = list(a.shape)
    shape[int(axis)] = 1
    return shape


def ediff1d(ary, to_end=None, to_begin=None):
    a = _arr(ary).reshape(-1)
    parts = []
    if to_begin is not None:
        parts.append(_arr(to_begin).to(a.dtype).reshape(-1))
    parts.append(a[1:] - a[:-1])
    if to_end is not None:
        parts.append(_arr(to_end).to(a.dtype).reshape(-1))
    return torch.cat(parts)


def gradient(f, *varargs, axis=None, edge_order=1):
    f = _arr(f)
    f = f.to(np_inexact(f.dtype))
    dims = _axes(axis, f.ndim)
    kw = {"dim": list(dims), "edge_order": int(edge_order)}
    if varargs:
        kw["spacing"] = [float(v) for v in varargs] if len(varargs) > 1 \
            else float(varargs[0])
    out = torch.gradient(f, **kw)
    return out[0] if len(dims) == 1 else list(out)


def trapezoid(y, x=None, dx=1.0, axis=-1):
    y = _arr(y)
    if x is not None:
        y, x = _operands(y, x, inexact=True)
        return torch.trapezoid(y, x, dim=int(axis))
    y = y.to(np_inexact(y.dtype))
    return torch.trapezoid(y, dx=float(dx), dim=int(axis))


def interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _operands(x, xp, fp, inexact=True)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(dx.dtype).eps
    safe = torch.where(torch.abs(dx) <= eps, torch.ones_like(dx), dx)
    f = torch.where(torch.abs(dx) <= eps, fp[i - 1],
                    fp[i - 1] + (delta / safe) * (fp[i] - fp[i - 1]))
    lo = fp[0] if left is None else torch.tensor(left, dtype=f.dtype,
                                                 device=f.device)
    hi = fp[-1] if right is None else torch.tensor(right, dtype=f.dtype,
                                                   device=f.device)
    f = torch.where(x < xp[0], lo, f)
    return torch.where(x > xp[-1], hi, f)


def _correlate_full(a, v):
    """The full cross-correlation of 1-D ``a`` and ``v``."""
    k = v.shape[0]
    out = F.conv1d(a.reshape(1, 1, -1), v.reshape(1, 1, -1), padding=k - 1)
    return out.reshape(-1)


def _mode_slice(full, n, m, mode):
    if mode == "full":
        return full
    if mode == "same":
        length = max(n, m)
        start = (full.shape[0] - length) // 2
        return full[start:start + length]
    length = max(n, m) - min(n, m) + 1
    start = min(n, m) - 1
    return full[start:start + length]


def convolve(a, v, mode="full", **kw):
    a, v = _operands(a, v)
    n, m = a.shape[0], v.shape[0]
    if m > n:
        a, v = v, a
    return _mode_slice(_correlate_full(a, v.flip(0)), n, m, mode)


def correlate(a, v, mode="valid", **kw):
    a, v = _operands(a, v)
    n, m = a.shape[0], v.shape[0]
    if m > n:
        return _mode_slice(_correlate_full(v, a), n, m, mode).flip(0)
    return _mode_slice(_correlate_full(a, v), n, m, mode)


# -- the quiet set: sorting, searching, counting -----------------------------

def sort(a, axis=-1, kind=None, order=None, stable=True, descending=False):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=int(axis), stable=True,
                      descending=bool(descending)).values


def argsort(a, axis=-1, kind=None, order=None, stable=True,
            descending=False):
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=int(axis), stable=True,
                      descending=bool(descending)).indices


def searchsorted(a, v, side="left", sorter=None, method=None):
    a = _arr(a)
    if sorter is not None:
        a = a[_arr(sorter).to(torch.int64)]
    v = _arr(v)
    a, v = _operands(a, v)
    out = torch.searchsorted(a, v.reshape(-1), right=side == "right",
                             out_int32=True)
    return out.reshape(v.shape)


def flatnonzero(a):
    return torch.nonzero(_arr(a).reshape(-1)).reshape(-1)


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None, equal_nan=True, **kw):
    ar = _arr(ar)
    flat = ar.reshape(-1) if axis is None else ar
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True,
                                     dim=None if axis is None else int(axis))
    outs = [vals]
    if return_index:
        n = flat.shape[0 if axis is None else int(axis)]
        first = torch.full((vals.shape[0 if axis is None else int(axis)],),
                           n, dtype=torch.int64, device=ar.device)
        first = first.scatter_reduce(0, inv.reshape(-1), torch.arange(
            n, device=ar.device), reduce="amin")
        outs.append(first)
    if return_inverse:
        outs.append(inv.reshape(ar.shape) if axis is None else inv)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def bincount(x, weights=None, minlength=0, *, length=None):
    x = _arr(x)
    w = None if weights is None else _arr(weights)
    n = max(int(minlength), int(x.max()) + 1 if x.numel() else 0)
    if length is not None:
        n = int(length)
    if w is None:
        return torch.bincount(x.to(torch.int64), minlength=n)[:n]
    w = w.to(np_result_type(w, x))
    out = torch.zeros(n, dtype=w.dtype, device=x.device)
    return out.index_add(0, x.to(torch.int64), w)


def digitize(x, bins, right=False):
    x, bins = _arr(x), _arr(bins)
    x, bins = _operands(x, bins)
    if bins.numel() > 1 and bool(bins[-1] < bins[0]):
        n = bins.shape[0]
        return n - torch.searchsorted(bins.flip(0), x, right=not right,
                                      out_int32=True)
    return torch.searchsorted(bins, x, right=not right, out_int32=True)


def _edges(a, bins, rng):
    if not isinstance(bins, int):
        return _arr(bins).to(torch.float64 if not a.is_floating_point()
                             else a.dtype)
    if rng is None:
        lo, hi = float(a.min()), float(a.max())
    else:
        lo, hi = float(rng[0]), float(rng[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    dt = a.dtype if a.is_floating_point() else torch.float64
    return torch.linspace(lo, hi, int(bins) + 1, dtype=torch.float64,
                          device=a.device).to(dt)


def _bin_of(a, edges):
    """Each value's bin, the last bin closed; -1 outside the edges."""
    n = edges.shape[0] - 1
    i = torch.searchsorted(edges, a.to(edges.dtype).contiguous(),
                           right=True) - 1
    i = torch.where(a.to(edges.dtype) == edges[-1], torch.full_like(
        i, n - 1), i)
    return torch.where((i < 0) | (i >= n), torch.full_like(i, -1), i)


def histogramdd(sample, bins=10, range=None, weights=None,  # noqa: A002
                density=None):
    s = _arr(sample)
    if s.ndim == 1:
        s = s.reshape(-1, 1)
    d = s.shape[1]
    bins = bins if isinstance(bins, (list, tuple)) else [bins] * d
    rng = range if range is not None else [None] * d
    edges = [_edges(s[:, j], bins[j], rng[j]) for j in builtins.range(d)]
    idx = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    valid = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for j, e in enumerate(edges):
        b = _bin_of(s[:, j], e)
        valid &= b >= 0
        idx = idx * (e.shape[0] - 1) + b.clamp_min(0)
    sizes = [e.shape[0] - 1 for e in edges]
    counts = weights is None and not density
    w = torch.ones(s.shape[0], dtype=torch.int64 if counts
                   else edges[0].dtype, device=s.device) \
        if weights is None else _arr(weights).to(edges[0].dtype)
    hist = torch.zeros(int(_onp.prod(sizes)), dtype=w.dtype,
                       device=s.device).index_add(0, idx[valid], w[valid])
    hist = hist.reshape(sizes)
    if density:
        widths = torch.ones(sizes, dtype=w.dtype, device=s.device)
        for j, e in enumerate(edges):
            shape = [1] * d
            shape[j] = -1
            widths = widths * (e[1:] - e[:-1]).reshape(shape)
        hist = hist / hist.sum() / widths
    return hist, edges


def histogram(a, bins=10, range=None,  # noqa: A002 - numpy's name
              weights=None, density=None):
    """Counts in ``a``'s inexact type, as ``jnp.histogram`` gives them
    (``histogram2d``/``histogramdd`` count in int64)."""
    a = _arr(a).reshape(-1)
    hist, edges = histogramdd(a, [bins], None if range is None else [range],
                              weights, density)
    if weights is None and not density:
        hist = hist.to(np_inexact(a.dtype))
    return hist, edges[0]


def histogram2d(x, y, bins=10, range=None, weights=None,  # noqa: A002
                density=None):
    x, y = _operands(x, y)
    hist, edges = histogramdd(torch.stack([x, y], dim=1),
                              bins if isinstance(bins, (list, tuple))
                              else [bins, bins], range, weights, density)
    return hist, edges[0], edges[1]


# -- the quiet set: constructors, dtypes, structure --------------------------

def shape(a):
    return tuple(_arr(a).shape)


def size(a, axis=None):
    a = _arr(a)
    return a.numel() if axis is None else a.shape[int(axis)]


def ndim(a):
    return _arr(a).ndim


def result_type(*arrays_and_dtypes):
    xs = []
    for x in arrays_and_dtypes:
        if isinstance(x, type) and x in _DEFAULT:  # ``float`` names float64
            xs.append(_DEFAULT[x])
        elif isinstance(x, (str, _onp.dtype, type, torch.dtype)):
            xs.append(torch_dtype(x))
        else:
            xs.append(_strong(x))
    return np_dtype(np_result_type(*xs))


def promote_types(type1, type2):
    return np_dtype(np_promote_types(torch_dtype(type1), torch_dtype(type2)))


def can_cast(from_, to, casting="safe"):
    if isinstance(from_, torch.Tensor):
        from_ = np_dtype(from_.dtype)
    return bool(_onp.can_cast(from_, np_dtype(to), casting))


def meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    arrays = [_arr(x).reshape(-1) for x in xi]
    if sparse:
        n = len(arrays)
        outs = []
        for i, a in enumerate(arrays):
            shape = [1] * n
            shape[i] = -1
            outs.append(a.reshape(shape))
        if indexing == "xy" and n > 1:
            outs[0], outs[1] = (outs[0].reshape(1, -1, *[1] * (n - 2)),
                                outs[1].reshape(-1, 1, *[1] * (n - 2)))
        return outs
    return list(torch.meshgrid(*arrays, indexing=indexing))


def indices(dimensions, dtype=None, sparse=False):
    dt = torch.int64 if dtype is None else torch_dtype(dtype)
    dims = tuple(int(d) for d in dimensions)
    aranges = [torch.arange(d, dtype=dt, device=_dev()) for d in dims]
    if sparse:
        n = len(dims)
        return tuple(a.reshape([-1 if j == i else 1 for j in range(n)])
                     for i, a in enumerate(aranges))
    if not dims:
        return torch.zeros((0,), dtype=dt, device=_dev())
    return torch.stack(torch.meshgrid(*aranges, indexing="ij"))


def unravel_index(indices, shape):  # noqa: F811 - numpy's names
    idx = _arr(indices)
    idx = torch.where(idx < 0, idx + int(_onp.prod(shape)), idx)
    outs = []
    for d in reversed(tuple(shape)):
        outs.append(torch.remainder(idx, int(d)))
        idx = torch.div(idx, int(d), rounding_mode="floor")
    return tuple(reversed(outs))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_arr(i) for i in multi_index]
    out = torch.zeros_like(idx[0])
    for i, d in zip(idx, dims):
        out = out * int(d) + i
    return out


def tril_indices(n, k=0, m=None):
    r = torch.tril_indices(int(n), int(n if m is None else m), int(k),
                           device=_dev())
    return r[0], r[1]


def triu_indices(n, k=0, m=None):
    r = torch.triu_indices(int(n), int(n if m is None else m), int(k),
                           device=_dev())
    return r[0], r[1]


def diag_indices(n, ndim=2):  # noqa: F811 - numpy's name
    a = torch.arange(int(n), device=_dev())
    return (a,) * int(ndim)


def ix_(*args):
    n = len(args)
    out = []
    for i, a in enumerate(args):
        a = _arr(a).reshape(-1)
        if a.dtype == torch.bool:
            a = torch.nonzero(a).reshape(-1)
        out.append(a.reshape([-1 if j == i else 1 for j in range(n)]))
    return tuple(out)


def asarray(a, dtype=None, order=None, copy=None, **kw):
    return _arr(a, dtype)


def _like(fill):
    def f(a, dtype=None, shape=None, **kw):
        a = _arr(a)
        dt = a.dtype if dtype is None else torch_dtype(dtype)
        s = a.shape if shape is None else tuple(
            (shape,) if isinstance(shape, int) else shape)
        return torch.full(s, fill, dtype=dt, device=a.device)
    return f


def full_like(a, fill_value, dtype=None, shape=None, **kw):
    a = _arr(a)
    dt = a.dtype if dtype is None else torch_dtype(dtype)
    s = a.shape if shape is None else tuple(
        (shape,) if isinstance(shape, int) else shape)
    if isinstance(fill_value, torch.Tensor):
        return fill_value.to(dt).broadcast_to(s).clone()
    return torch.full(s, fill_value, dtype=dt, device=a.device)


def copy(a, order="K", **kw):
    return _arr(a).clone()


def astype(x, dtype, copy=True, **kw):
    return _arr(x).to(torch_dtype(dtype))


def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*[
        (s,) if isinstance(s, int) else tuple(s) for s in shapes]))


def _host(a):
    a = _arr(a).detach().cpu()
    if a.dtype == torch.bfloat16:
        return a.float().numpy().astype(np_dtype("bfloat16"))
    return a.numpy()


def array2string(a, *args, **kw):
    return _onp.array2string(_host(a), *args, **kw)


def array_repr(arr, *args, **kw):
    return _onp.array_repr(_host(arr), *args, **kw)


def array_str(a, *args, **kw):
    return _onp.array_str(_host(a), *args, **kw)


def base_repr(number, base=2, padding=0):
    return _onp.base_repr(int(number), base, padding)


def binary_repr(num, width=None):
    return _onp.binary_repr(int(num), width)


def isscalar(element):
    if isinstance(element, torch.Tensor):
        return element.ndim == 0
    return bool(_onp.isscalar(element))


def iterable(y):
    if isinstance(y, torch.Tensor):
        return y.ndim > 0
    return bool(_onp.iterable(y))


def may_share_memory(a, b, max_work=None):
    a, b = _arr(a), _arr(b)
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


#: name -> implementation, for both of ``mx.np``'s sets
IMPL = {
    # arithmetic
    "add": _binary(torch.add),
    "subtract": _binary(torch.sub),
    "multiply": _binary(torch.mul),
    "divide": _binary(torch.div, inexact=True),
    "true_divide": _binary(torch.div, inexact=True),
    "power": _binary(torch.pow),
    "float_power": _binary(torch.pow, inexact=True),
    "mod": _binary(torch.remainder),
    "remainder": _binary(torch.remainder),
    "fmod": _binary(torch.fmod),
    "maximum": _binary(torch.maximum),
    "minimum": _binary(torch.minimum),
    "fmax": _binary(torch.fmax),
    "fmin": _binary(torch.fmin),
    "hypot": _binary(torch.hypot, inexact=True),
    "logaddexp": _binary(torch.logaddexp, inexact=True),
    "logaddexp2": _binary(torch.logaddexp2, inexact=True),
    "arctan2": _binary(torch.atan2, inexact=True),
    "heaviside": heaviside,
    "copysign": _binary(torch.copysign, inexact=True),
    "floor_divide": _binary(torch.floor_divide),
    "divmod": divmod_,
    "matmul": matmul, "dot": dot, "vdot": vdot, "inner": inner,
    "outer": outer, "tensordot": tensordot, "einsum": einsum,
    "kron": kron, "cross": cross,
    # unary
    "exp": _unary(torch.exp, inexact=True),
    "exp2": _unary(torch.exp2, inexact=True),
    "expm1": _unary(torch.expm1, inexact=True),
    "log": _unary(torch.log, inexact=True),
    "log2": _unary(torch.log2, inexact=True),
    "log10": _unary(torch.log10, inexact=True),
    "log1p": _unary(torch.log1p, inexact=True),
    "sqrt": _unary(torch.sqrt, inexact=True),
    "cbrt": _unary(_cbrt, inexact=True),
    "square": _unary(_square),
    "reciprocal": _unary(torch.reciprocal, inexact=True),
    "positive": _unary(torch.clone),
    "negative": _unary(torch.neg),
    "abs": _unary(_abs),
    "absolute": _unary(_abs),
    "fabs": _unary(torch.abs, inexact=True),
    "sign": _unary(torch.sign),
    "sin": _unary(torch.sin, inexact=True),
    "cos": _unary(torch.cos, inexact=True),
    "tan": _unary(torch.tan, inexact=True),
    "arcsin": _unary(torch.asin, inexact=True),
    "arccos": _unary(torch.acos, inexact=True),
    "arctan": _unary(torch.atan, inexact=True),
    "sinh": _unary(torch.sinh, inexact=True),
    "cosh": _unary(torch.cosh, inexact=True),
    "tanh": _unary(torch.tanh, inexact=True),
    "arcsinh": _unary(torch.asinh, inexact=True),
    "arccosh": _unary(torch.acosh, inexact=True),
    "arctanh": _unary(torch.atanh, inexact=True),
    "deg2rad": _unary(torch.deg2rad, inexact=True),
    "rad2deg": _unary(torch.rad2deg, inexact=True),
    "degrees": _unary(torch.rad2deg, inexact=True),
    "radians": _unary(torch.deg2rad, inexact=True),
    "real": _real, "imag": _imag, "conj": _conj, "conjugate": _conj,
    "nan_to_num": nan_to_num,
    # reductions
    "sum": sum_, "mean": mean, "prod": prod, "std": std, "var": var,
    "median": median, "average": average, "ptp": ptp, "nansum": nansum,
    "nanmean": nanmean, "nanprod": nanprod,
    "cumsum": _cum(torch.cumsum), "cumprod": _cum(torch.cumprod),
    "amin": _amin, "amax": _amax, "min": _amin, "max": _amax,
    "nanmin": nanmin, "nanmax": nanmax, "clip": clip, "interp": interp,
    # shapes
    "reshape": reshape, "ravel": ravel, "flatten": ravel,
    "transpose": transpose, "swapaxes": swapaxes, "moveaxis": moveaxis,
    "rollaxis": rollaxis, "concatenate": concatenate, "stack": stack,
    "vstack": vstack, "row_stack": vstack, "hstack": hstack,
    "dstack": dstack, "column_stack": column_stack, "split": split,
    "array_split": array_split, "hsplit": hsplit, "vsplit": vsplit,
    "dsplit": dsplit, "squeeze": squeeze, "expand_dims": expand_dims,
    "broadcast_to": broadcast_to, "repeat": repeat, "tile": tile,
    "flip": flip, "fliplr": fliplr, "flipud": flipud, "roll": roll,
    "rot90": rot90, "atleast_1d": _atleast(torch.atleast_1d),
    "atleast_2d": _atleast(torch.atleast_2d),
    "atleast_3d": _atleast(torch.atleast_3d),
    # indexing
    "where": where, "take": take, "take_along_axis": take_along_axis,
    "compress": compress, "extract": extract, "diag": diag,
    "diagonal": diagonal, "trace": trace, "tril": tril, "triu": triu,
    "pad": pad, "delete": delete, "insert": insert, "append": append,
    "select": select, "diff": diff, "ediff1d": ediff1d,
    "gradient": gradient, "trapz": trapezoid, "trapezoid": trapezoid,
    "convolve": convolve, "correlate": correlate,
    # the quiet set
    "argmax": argmax, "argmin": argmin, "argsort": argsort, "sort": sort,
    "searchsorted": searchsorted, "nonzero": nonzero,
    "flatnonzero": flatnonzero, "unique": unique,
    "count_nonzero": count_nonzero, "bincount": bincount,
    "digitize": digitize, "histogram": histogram,
    "histogram2d": histogram2d, "histogramdd": histogramdd,
    "floor": _integral(torch.floor), "ceil": _integral(torch.ceil),
    "trunc": _integral(torch.trunc), "fix": _integral(torch.trunc),
    "rint": rint, "round": _round, "around": _round,
    "signbit": _unary(torch.signbit),
    "equal": _binary(torch.eq), "not_equal": _binary(torch.ne),
    "greater": _binary(torch.gt),
    "greater_equal": _binary(torch.ge),
    "less": _binary(torch.lt), "less_equal": _binary(torch.le),
    "isclose": isclose, "allclose": allclose, "array_equal": array_equal,
    "array_equiv": array_equiv,
    "isnan": _unary(torch.isnan), "isinf": _unary(torch.isinf),
    "isfinite": _unary(torch.isfinite), "isneginf": _unary(torch.isneginf),
    "isposinf": _unary(torch.isposinf), "iscomplex": iscomplex,
    "isreal": isreal,
    "all": _logical_reduce(torch.all), "any": _logical_reduce(torch.any),
    "logical_and": _binary(torch.logical_and),
    "logical_or": _binary(torch.logical_or),
    "logical_xor": _binary(torch.logical_xor),
    "logical_not": _unary(torch.logical_not),
    "bitwise_and": _binary(torch.bitwise_and),
    "bitwise_or": _binary(torch.bitwise_or),
    "bitwise_xor": _binary(torch.bitwise_xor),
    "bitwise_not": _unary(torch.bitwise_not),
    "invert": _unary(torch.bitwise_not),
    "left_shift": _binary(torch.bitwise_left_shift),
    "right_shift": _binary(torch.bitwise_right_shift),
    "shape": shape, "size": size, "ndim": ndim,
    "may_share_memory": may_share_memory, "result_type": result_type,
    "can_cast": can_cast, "promote_types": promote_types,
    "meshgrid": meshgrid, "indices": indices,
    "unravel_index": unravel_index, "ravel_multi_index": ravel_multi_index,
    "tril_indices": tril_indices, "triu_indices": triu_indices,
    "diag_indices": diag_indices, "ix_": ix_, "asarray": asarray,
    "ascontiguousarray": asarray, "empty_like": _like(0),
    "zeros_like": _like(0), "ones_like": _like(1), "full_like": full_like,
    "copy": copy, "astype": astype, "broadcast_shapes": broadcast_shapes,
    "array2string": array2string, "array_repr": array_repr,
    "array_str": array_str, "base_repr": base_repr,
    "binary_repr": binary_repr, "isscalar": isscalar,
    "iterable": iterable,
}
