"""Elementwise, broadcast, reduction, scan and product operators (port
of ``incubator_mxnet_tpu/ops/math.py``; its linalg family is in
``ops/linalg.py``).

Each op is one function on torch tensors.  Dtypes follow the reference:
comparisons return 0/1 in the inputs' type, ``argmax``/``argmin`` return
float32 indices, ``argsort``/``topk`` indices take ``dtype`` (float32 by
default).  Sorting is stable, so ties come out in the reference's order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

# ---------------------------------------------------------------------------
# binary broadcast (math.py _BINARY, _CMP)
# ---------------------------------------------------------------------------

_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
}
_BINARY_ALIASES = {
    "broadcast_add": ("elemwise_add", "_add", "_plus", "_Plus"),
    "broadcast_sub": ("elemwise_sub", "_sub", "_minus", "_Minus"),
    "broadcast_mul": ("elemwise_mul", "_mul", "_Mul"),
    "broadcast_div": ("elemwise_div", "_div", "_Div"),
    "broadcast_power": ("_power", "_Power", "pow"),
    "broadcast_mod": ("_mod",),
    "broadcast_maximum": ("_maximum",),
    "broadcast_minimum": ("_minimum",),
}
for _name, _f in _BINARY.items():
    register(_name, (lambda f: lambda lhs, rhs: f(lhs, rhs))(_f),
             num_inputs=2, aliases=_BINARY_ALIASES.get(_name, ()))

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}
for _name, _f in _CMP.items():
    # 0/1 in the inputs' type, as MXNet's comparisons return
    register(_name,
             (lambda f: lambda lhs, rhs: f(lhs, rhs).to(
                 torch.result_type(lhs, rhs)))(_f),
             num_inputs=2, differentiable=False,
             aliases=(_name.replace("broadcast_", "_"),))


# ---------------------------------------------------------------------------
# scalar ops (math.py _scalar_op; the Symbol arithmetic emits them)
# ---------------------------------------------------------------------------


def _scalar_op(name, fn, reverse_fn=None, differentiable=True, aliases=()):
    register(name, (lambda f: lambda data, scalar=1.0: f(data, scalar))(fn),
             num_inputs=1, differentiable=differentiable, aliases=aliases)
    if reverse_fn is not None:
        register("_r" + name.lstrip("_"),
                 (lambda f: lambda data, scalar=1.0: f(data, scalar))(
                     reverse_fn),
                 num_inputs=1, differentiable=differentiable)


def _as_dtype_of(fn):
    """A comparison as 0/1 in the input's type."""
    return lambda x, s: fn(x, s).to(x.dtype)


_scalar_op("_plus_scalar", lambda x, s: x + s, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", lambda x, s: x - s, lambda x, s: s - x,
           aliases=("_MinusScalar",))
_scalar_op("_mul_scalar", lambda x, s: x * s, aliases=("_MulScalar",))
_scalar_op("_div_scalar", lambda x, s: x / s, lambda x, s: s / x,
           aliases=("_DivScalar",))
_scalar_op("_power_scalar", torch.pow, lambda x, s: torch.pow(s, x))
_scalar_op("_mod_scalar", torch.remainder, lambda x, s: torch.remainder(s, x))
_scalar_op("_maximum_scalar", lambda x, s: torch.clamp_min(x, s))
_scalar_op("_minimum_scalar", lambda x, s: torch.clamp_max(x, s))
for _name, _f in (("_equal_scalar", torch.eq), ("_not_equal_scalar", torch.ne),
                  ("_greater_scalar", torch.gt),
                  ("_greater_equal_scalar", torch.ge),
                  ("_lesser_scalar", torch.lt),
                  ("_lesser_equal_scalar", torch.le)):
    _scalar_op(_name, _as_dtype_of(_f), differentiable=False)


# ---------------------------------------------------------------------------
# unary (math.py _UNARY, _UNARY_NONDIFF)
# ---------------------------------------------------------------------------


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x, alpha=0.2, beta=0.5: torch.clamp(
        alpha * x + beta, 0, 1),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "tanh": torch.tanh,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "square": torch.square,
    "reciprocal": lambda x: 1.0 / x,
    "negative": torch.neg,
    "abs": torch.abs,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "identity": lambda x: x.clone(),
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
}
_UNARY_ALIASES = {
    "identity": ("_copy",),
    "abs": ("_abs",),
    "negative": ("_neg",),
}
for _name, _f in _UNARY.items():
    register(_name, (lambda f: lambda data, **kw: f(data, **kw))(_f),
             num_inputs=1, aliases=_UNARY_ALIASES.get(_name, ()))

_UNARY_NONDIFF = {
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
}
for _name, _f in _UNARY_NONDIFF.items():
    register(_name, (lambda f: lambda data: f(data))(_f), num_inputs=1,
             differentiable=False)


@register("clip", num_inputs=1)
def _clip(data, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


@register("BlockGrad", num_inputs=1, aliases=("stop_gradient",))
def _block_grad(data):
    return data.detach()


# ---------------------------------------------------------------------------
# reductions (math.py :225)
# ---------------------------------------------------------------------------


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _prod(x, dims, keepdim):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn):
    """``fn(x, dims, keepdim)`` over the reference's ``axis``/``exclude``;
    ``axis=None`` reduces every axis, ``keepdims`` keeps them as 1s."""
    def impl(data, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, data.ndim, exclude)
        if ax is None:
            ax = tuple(range(data.ndim))
        if not ax:
            return data.clone()
        return fn(data, ax, bool(keepdims))

    return impl


register("sum", _reduce(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)),
         num_inputs=1, aliases=("sum_axis",))
register("mean", _reduce(lambda x, d, k: torch.mean(x, dim=d, keepdim=k)),
         num_inputs=1)
register("prod", _reduce(_prod), num_inputs=1)
register("nansum", _reduce(lambda x, d, k: torch.nansum(x, dim=d,
                                                        keepdim=k)),
         num_inputs=1)
register("nanprod", _reduce(lambda x, d, k: _prod(
    torch.where(torch.isnan(x), torch.ones((), dtype=x.dtype,
                                           device=x.device), x), d, k)),
    num_inputs=1)
register("max", _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
         num_inputs=1, aliases=("max_axis",))
register("min", _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k)),
         num_inputs=1, aliases=("min_axis",))


@register("norm", num_inputs=1)
def _norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    ax = _norm_axis(axis, data.ndim)
    if ax is None:
        ax = tuple(range(data.ndim))
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=bool(keepdims)))


def _arg(fn, data, axis, keepdims):
    """Index of the first extreme, as float32 (MXNet returns float
    indices)."""
    if axis is None:
        out = fn(data.reshape(-1), 0)
        if keepdims:
            out = out.reshape((1,) * data.ndim)
    else:
        out = fn(data, axis, keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax", num_inputs=1, differentiable=False)
def _argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", num_inputs=1, differentiable=False)
def _argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", num_inputs=1, differentiable=False)
def _argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# sorting / topk (math.py :263)
# ---------------------------------------------------------------------------


@register("sort", num_inputs=1)
def _sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort", num_inputs=1, differentiable=False)
def _argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(torch_dtype(dtype))


@register("topk", num_inputs=1, differentiable=False)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The reference's ``lax.top_k`` on the moved axis: the k largest (or
    smallest), ties to the lower index."""
    axis = axis if axis is not None else -1
    moved = torch.movedim(data, axis, -1)
    vals, idx = torch.sort(moved, dim=-1, descending=not is_ascend,
                           stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        hot = idx[..., None] == torch.arange(moved.shape[-1],
                                             device=data.device)
        return torch.movedim(hot.to(data.dtype).sum(dim=-2), -1, axis)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis).to(torch_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return vals, idx  # 'both'


# ---------------------------------------------------------------------------
# dot / batch_dot (math.py :306), softmax (:360)
# ---------------------------------------------------------------------------


def _reversed_axes(t):
    return t.permute(*reversed(range(t.ndim)))


@register("dot", num_inputs=2)
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = _reversed_axes(lhs) if transpose_a else lhs
    b = _reversed_axes(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    # MXNet's dot contracts the last axis of a with the first of b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register("batch_dot", num_inputs=2)
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("log_softmax", num_inputs=1)
def _log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return F.log_softmax(data, dim=axis)


@register("softmax", num_inputs=1)
def _softmax(data, axis=-1, temperature=None, length=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return F.softmax(data, dim=axis)


# ---------------------------------------------------------------------------
# the rest of the reference's math.py
# ---------------------------------------------------------------------------


@register("_scatter_elemwise_div", num_inputs=2)
def _scatter_div(lhs, rhs):
    return lhs / rhs


@register("make_loss", num_inputs=1, aliases=("MakeLoss",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """The identity, as the reference's body: the head gradient passes
    through and ``grad_scale``, ``valid_thresh`` and ``normalization``
    are accepted and unused (ROADMAP Queue C)."""
    return data.view_as(data)


@register("smooth_l1", num_inputs=1)
def _smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)


@register("gelu", num_inputs=1)
def _gelu(data, approximate=False):
    return F.gelu(data, approximate="tanh" if approximate else "none")


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def _add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("khatri_rao")
def _khatri_rao(*mats):
    """The column-wise Kronecker product of (r_i, k) matrices."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("softmin", num_inputs=1)
def _softmin(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return F.softmax(-data, dim=axis)


@register("cumsum", num_inputs=1)
def _cumsum(a, axis=None, dtype=None):
    """Running sum along ``axis`` (of the flattened array without one), in
    ``dtype`` or else the input's (a boolean input counts in int64), as
    ``jnp.cumsum``."""
    if axis is None:
        a = a.reshape(-1)
        axis = 0
    out = torch.cumsum(a, dim=axis)
    if dtype is not None:
        return out.to(torch_dtype(dtype))
    return out if a.dtype == torch.bool else out.to(a.dtype)


@register("diag", num_inputs=1)
def _diag(data, k=0, axis1=0, axis2=1):
    if data.ndim == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)
