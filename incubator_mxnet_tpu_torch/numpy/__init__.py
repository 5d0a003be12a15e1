"""``mx.np``: the NumPy-compatible array API with autograd (port of
``incubator_mxnet_tpu/numpy/__init__.py``).

``mx.np.ndarray`` is the port's :class:`~..ndarray.NDArray`.  Every
function of the reference's two dispatch sets has an explicit torch
implementation (``_impl.IMPL``) with NumPy's semantics and the
reference's dtypes:

* the differentiable set (``_DIFFERENTIABLE``) records on the port's
  autograd only inside ``autograd.record()`` and only where an input
  requires a gradient, as ``ops.registry.invoke`` does; outside, its
  results are detached;
* the quiet set (``_NONDIFF``: integer, boolean and piecewise-constant
  results) never records.

The explicit constructors (``array``, ``zeros``, ``ones``, ``full``,
``arange``, ``eye``) take ``ctx`` and default to the port's default
device: the card, or the enclosing ``context.device_scope``'s device;
without a card they raise unless asked for the CPU.  A function given
no array builds on that device too; one given arrays runs on its
first array's device.  Of the reference's catch-all over the rest of
``jax.numpy`` the port has the names its tests call (``copysign``: it
does not record, and warns once under recording, as the reference's
catch-all does); any other name raises ``AttributeError``, ROADMAP
A13's later item.
"""
from __future__ import annotations

import builtins
import functools
import sys
import warnings

import numpy as _onp
import torch

from .. import autograd, context
from ..base import torch_dtype
from ..ndarray import NDArray
from ..ndarray.ndarray import array as _nd_array
from . import _impl
from . import linalg  # noqa: F401
from . import random  # noqa: F401

ndarray = NDArray

_DIFFERENTIABLE = frozenset("""
add subtract multiply divide true_divide power float_power mod remainder
fmod maximum minimum fmax fmin matmul dot vdot inner outer tensordot einsum
kron cross
exp exp2 expm1 log log2 log10 log1p sqrt cbrt square reciprocal positive
negative abs absolute fabs sign hypot logaddexp logaddexp2
sin cos tan arcsin arccos arctan arctan2 sinh cosh tanh arcsinh arccosh
arctanh deg2rad rad2deg degrees radians
sum mean prod std var median average ptp nansum nanmean nanprod cumsum
cumprod amin amax min max nanmin nanmax
clip interp
reshape ravel transpose swapaxes moveaxis rollaxis concatenate stack vstack
hstack dstack column_stack row_stack split array_split hsplit vsplit dsplit
squeeze expand_dims broadcast_to repeat tile flip fliplr flipud roll rot90
atleast_1d atleast_2d atleast_3d
where take take_along_axis compress extract diag diagonal trace tril triu
pad real imag conj conjugate flatten delete insert append select
heaviside nan_to_num diff ediff1d gradient trapz trapezoid convolve correlate
""".split())

_NONDIFF = frozenset("""
argmax argmin argsort sort searchsorted nonzero flatnonzero unique
count_nonzero bincount digitize histogram histogram2d histogramdd
floor ceil rint trunc round around fix sign signbit
equal not_equal greater greater_equal less less_equal isclose allclose
array_equal array_equiv isnan isinf isfinite isneginf isposinf iscomplex
isreal all any logical_and logical_or logical_not logical_xor
bitwise_and bitwise_or bitwise_xor bitwise_not invert left_shift right_shift
floor_divide divmod shape size ndim copyto may_share_memory result_type
can_cast promote_types meshgrid indices unravel_index ravel_multi_index
tril_indices triu_indices diag_indices ix_ asarray ascontiguousarray
empty_like zeros_like ones_like full_like copy astype broadcast_shapes
array2string array_repr array_str base_repr binary_repr isscalar iterable
""".split())


#: names outside both sets that the reference resolves through its
#: catch-all over ``jax.numpy`` and its own tests call: they do not
#: record, and warn once when called under ``autograd.record()``
_PASSTHROUGH = frozenset(["copysign"])

_WARNED_PASSTHROUGH = set()


def _leaves(obj):
    if isinstance(obj, NDArray):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _leaves(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)


def _unwrap(obj):
    if isinstance(obj, NDArray):
        return obj._data
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unwrap(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    return obj


def _detached(kwargs):
    return {k: v._data.detach() if isinstance(v, NDArray) else _unwrap(v)
            for k, v in kwargs.items()}


def _wrap(obj, recording):
    if isinstance(obj, torch.Tensor):
        return NDArray(obj if recording else obj.detach())
    if isinstance(obj, (tuple, list)):
        return type(obj)(_wrap(v, recording) for v in obj)
    return obj


def _dispatch(name, impl, differentiable):
    """``impl`` on the unwrapped arguments, recorded as the reference's
    generic recorder records a ``jnp`` function."""

    @functools.wraps(impl)
    def fn(*args, **kwargs):
        # the positional arrays (in sequences too) are the differentiable
        # inputs; keyword arrays are constants, as in the reference
        arrays = list(_leaves(args))
        # builtins.any: this module's own ``any`` is mx.np.any once used
        recording = (differentiable and autograd.is_recording()
                     and builtins.any(autograd.requires_grad(a)
                                      for a in arrays))
        first = arrays or list(_leaves(kwargs))
        prev = getattr(_impl._STATE, "device", None)
        _impl._STATE.device = first[0]._data.device if first else None
        try:
            with torch.set_grad_enabled(recording):
                out = impl(*_unwrap(args), **_detached(kwargs))
        finally:
            _impl._STATE.device = prev
        return _wrap(out, recording)

    fn.__name__ = name
    return fn


def _passthrough(name, impl):
    quiet = _dispatch(name, impl, False)

    @functools.wraps(impl)
    def fn(*args, **kwargs):
        if autograd.is_recording() and name not in _WARNED_PASSTHROUGH:
            _WARNED_PASSTHROUGH.add(name)
            warnings.warn(
                "mx.np.%s is not in the differentiable dispatch set; its "
                "result will NOT record on the autograd tape" % name,
                stacklevel=2)
        return quiet(*args, **kwargs)

    fn.__name__ = name
    return fn


def copyto(dst, src, casting="same_kind", where=None):
    """Write ``src`` (broadcast and cast to ``dst``'s type) into the
    NDArray ``dst``, where ``where`` is true."""
    data = dst._data
    src = _unwrap(src)
    with torch.no_grad():
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(_onp.asarray(src), device=data.device)
        new = src.to(data.device, data.dtype).broadcast_to(data.shape)
        if where is not None:
            mask = torch.as_tensor(_unwrap(where), device=data.device)
            new = torch.where(mask.to(torch.bool), new, data)
    dst._set_data(new.clone())


def array(obj, dtype=None, ctx=None):
    return _nd_array(obj, ctx=ctx, dtype=dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=None, order="C", ctx=None):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=context.resolve(ctx)))


def ones(shape, dtype=None, order="C", ctx=None):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=context.resolve(ctx)))


def _weak_dtype(*values):
    return _impl._DEFAULT[float] if builtins.any(
        isinstance(v, float) for v in values) else _impl._DEFAULT[int]


def full(shape, fill_value, dtype=None, order="C", ctx=None):
    dev = context.resolve(ctx)
    if isinstance(fill_value, NDArray):
        fill = fill_value._data.to(dev)
        dt = fill.dtype if dtype is None else torch_dtype(dtype)
        return NDArray(fill.to(dt).broadcast_to(_shape(shape)).clone())
    dt = torch_dtype(dtype) if dtype is not None else (
        torch.bool if isinstance(fill_value, bool)
        else _weak_dtype(fill_value))
    return NDArray(torch.full(_shape(shape), fill_value, dtype=dt,
                              device=dev))


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    """``jnp.arange``: int64 for integer arguments, float64 where one is a
    float, unless ``dtype`` says."""
    if stop is None:
        start, stop = 0, start
    dt = torch_dtype(dtype) if dtype is not None else _weak_dtype(
        start, stop, step)
    return NDArray(torch.arange(start, stop, step, dtype=torch.float64
                                if dt.is_floating_point else torch.int64,
                                device=context.resolve(ctx)).to(dt))


def eye(N, M=None, k=0, dtype=None, ctx=None):  # noqa: N803
    n, m = int(N), int(N if M is None else M)
    out = torch.zeros((n, m), dtype=torch_dtype(dtype),
                      device=context.resolve(ctx))
    if -n < k < m:
        out.diagonal(int(k)).fill_(1)
    return NDArray(out)


# dtype names (NumPy's)
float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
dtype = _onp.dtype


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    impl = _impl.IMPL.get(name)
    if impl is None or (name not in _DIFFERENTIABLE and name not in _NONDIFF
                        and name not in _PASSTHROUGH):
        raise AttributeError(
            "mx.np has no attribute %r in the port: the reference's "
            "catch-all over the rest of jax.numpy is ROADMAP A13's later "
            "item" % name)
    if name in _PASSTHROUGH:
        fn = _passthrough(name, impl)
    else:
        fn = _dispatch(name, impl, name in _DIFFERENTIABLE)
    setattr(sys.modules[__name__], name, fn)
    return fn


def __dir__():
    return builtins.sorted(builtins.set(globals()) | _DIFFERENTIABLE
                           | _NONDIFF)
