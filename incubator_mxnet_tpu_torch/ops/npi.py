"""NumPy-internal op names (port of ``incubator_mxnet_tpu/ops/npi.py``).

The reference's ``mx.np`` frontend bottoms out in the ``_npi_*``/
``_np_*``/``_npx_*`` names, and invoke-by-name consumers (the C ABI,
exported symbol JSON) call them directly.  Most are other names of the
canonical ops, made here as the reference makes them: the renames of
``_RENAMES`` and the automatic ``_npi_<name>`` loop resolve against
whatever the registry holds when this module is imported (last, as in
the reference).  The rest are bodies in torch ops with ``jax.numpy``'s
dtypes (64-bit types on, Python scalars weak: ``base.np_result_type``,
``base.np_inexact``).

Ops the reference evaluates on the host (``_npi_tensorinv``,
``_npi_tensorsolve``, ``_npi_svd``, ``_npi_bincount``, ``_npi_delete``)
are ``no_trace`` here too: they compute with torch on the input's device
and :meth:`Op.infer` refuses them.  The SVD's signs are the solver's
(cuSOLVER's on the card, LAPACK's on the CPU): ``u * s @ vt`` is what
they share.
"""
from __future__ import annotations

import math

import torch

from ..base import np_inexact, np_result_type, torch_dtype
from .nn import resize_bilinear
from .registry import OPS, alias, register

# -- direct renames onto existing canonical ops ------------------------------

_RENAMES = {
    "_npi_absolute": "abs",
    "_npi_add_scalar": "_plus_scalar",
    "_npi_subtract_scalar": "_minus_scalar",
    "_npi_rsubtract_scalar": "_rminus_scalar",
    "_npi_multiply_scalar": "_mul_scalar",
    "_npi_true_divide_scalar": "_div_scalar",
    "_npi_rtrue_divide_scalar": "_rdiv_scalar",
    "_npi_power_scalar": "_power_scalar",
    "_npi_rpower_scalar": "_rpower_scalar",
    "_npi_mod_scalar": "_mod_scalar",
    "_npi_rmod_scalar": "_rmod_scalar",
    "_npi_subtract": "broadcast_sub",
    "_npi_multiply": "broadcast_mul",
    "_npi_true_divide": "broadcast_div",
    "_npi_unique": "_np_unique",
    "_npx_nonzero": "_np_nonzero",
    "_np_copy": "_copy",
    "_npi_cholesky": "linalg_potrf",
    "_npi_tensordot_int_axes": "tensordot",
}

#: the automatic ``_npi_<name>`` aliases: the first of ``<name>``,
#: ``broadcast_<name>``, ``sample_<name>``, ``_random_<name>`` registered
_AUTO = ("arange arccos arccosh arcsin arcsinh arctan arctanh argmax argmin "
         "bernoulli bitwise_and cbrt ceil choice cos cosh degrees exp expm1 "
         "eye fix flip floor hypot identity lcm log log10 log1p log2 "
         "logical_not mean multinomial negative normal ones power radians "
         "reciprocal rint sign sin sinh sqrt square stack tan tanh tril "
         "trunc uniform where zeros mod dot cumsum diag hsplit split").split()


def _register_renames_and_autoaliases():
    for new, old in _RENAMES.items():
        if new not in OPS and old in OPS:
            alias(new, old)
    for base in _AUTO:
        npi = "_npi_" + base
        if npi in OPS:
            continue
        for cand in (base, "broadcast_" + base, "sample_" + base,
                     "_random_" + base):
            if cand in OPS:
                alias(npi, cand)
                break


_register_renames_and_autoaliases()


# -- helpers -----------------------------------------------------------------

def _cast(dtype, *xs):
    """Each tensor of ``xs`` cast to ``dtype``; a Python number becomes a
    0-d tensor of it on the first tensor's device."""
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    return [x.to(dtype) if isinstance(x, torch.Tensor)
            else torch.tensor(x, dtype=dtype, device=dev) for x in xs]


def _inexact(*xs):
    """``xs`` cast to the inexact type ``jax.numpy`` computes them in."""
    return _cast(np_inexact(np_result_type(*xs)), *xs)


def _promoted(*xs):
    return _cast(np_result_type(*xs), *xs)


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _sum_dtype(x):
    """``jnp.sum``'s type: booleans and narrower integers widen to int64."""
    if x.dtype == torch.bool or (not x.is_floating_point()
                                 and not x.is_complex()):
        return torch.int64
    return x.dtype


# -- bodies for names with no canonical equivalent ---------------------------

@register("_npi_arctan2", num_inputs=2, aliases=("arctan2",))
def _arctan2(x1, x2):
    return torch.atan2(*_inexact(x1, x2))


@register("_npi_arctan2_scalar", num_inputs=1)
def _arctan2_scalar(x, scalar=0.0):
    return torch.atan2(*_inexact(x, float(scalar)))


@register("_npi_rarctan2_scalar", num_inputs=1)
def _rarctan2_scalar(x, scalar=0.0):
    return torch.atan2(*_inexact(float(scalar), x))


@register("_npi_copysign", num_inputs=2, aliases=("copysign",))
def _copysign(x1, x2):
    return torch.copysign(*_inexact(x1, x2))


@register("_npi_copysign_scalar", num_inputs=1)
def _copysign_scalar(x, scalar=0.0):
    return torch.copysign(*_inexact(x, float(scalar)))


@register("_npi_rcopysign_scalar", num_inputs=1)
def _rcopysign_scalar(x, scalar=0.0):
    return torch.copysign(*_inexact(float(scalar), x))


def _pow2(x):
    """``jnp.power(2.0, x)``: the weak 2.0 takes ``x``'s float type."""
    two, e = _inexact(2.0, x)
    return torch.pow(two, e)


@register("_npi_ldexp", num_inputs=2, aliases=("ldexp",))
def _ldexp(x1, x2):
    a, b = _promoted(x1, _pow2(x2))
    return a * b


@register("_npi_ldexp_scalar", num_inputs=1)
def _ldexp_scalar(x, scalar=0.0):
    a, b = _promoted(x, float(2.0 ** scalar))
    return a * b


@register("_npi_rldexp_scalar", num_inputs=1)
def _rldexp_scalar(x, scalar=0.0):
    a, b = _promoted(float(scalar), _pow2(x))
    return a * b


@register("_npi_bitwise_not", num_inputs=1, differentiable=False)
def _bitwise_not(x):
    return torch.bitwise_not(x)  # a boolean's is its logical not


@register("_npi_concatenate", aliases=("concatenate",))
def _concatenate(*data, axis=0):
    data = _promoted(*data)
    if axis is None:
        return torch.cat([d.reshape(-1) for d in data])
    return torch.cat(data, dim=int(axis))


def _round_even(x, decimals):
    """``jnp.round``: half to even at ``decimals`` in ``x``'s type."""
    if not x.is_floating_point():
        return x
    factor = torch.tensor(10.0 ** int(decimals), dtype=x.dtype,
                          device=x.device)
    return torch.round(x * factor) / factor


@register("_npi_around", num_inputs=1, aliases=("around",))
def _around(x, decimals=0):
    return _round_even(x, decimals)


def _like(value, device):
    """An array-like attribute as a tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if hasattr(value, "_data"):  # an NDArray
        return value._data.to(device)
    import numpy as np

    return torch.as_tensor(np.asarray(value), device=device)


def _mean(x, axis=None, keepdims=False):
    """``jnp.mean``: integers and booleans average in their inexact
    type."""
    ax = _axis(axis)
    x = x.to(np_inexact(x.dtype))
    if ax is None:
        ax = tuple(range(x.ndim))
    return torch.mean(x, dim=ax, keepdim=bool(keepdims))


@register("_npi_average", num_inputs=1, aliases=("average",))
def _average(a, weights=None, axis=None, returned=False):
    """``jnp.average``; ``returned`` also gives the sum of the weights (the
    count where there are none), broadcast to the average's shape."""
    ax = None if axis is None else int(axis)
    if weights is None:
        out = _mean(a, ax)
        scl = None
    else:
        w = _like(weights, a.device)
        a_, w_ = _inexact(a, w)
        if ax is not None and w_.ndim == 1 and a_.ndim > 1:
            shape = [1] * a_.ndim
            shape[ax] = -1
            w_ = w_.reshape(shape)
        w_ = torch.broadcast_to(w_, a_.shape)
        dims = tuple(range(a_.ndim)) if ax is None else ax
        scl = w_.sum(dim=dims)
        out = (a_ * w_).sum(dim=dims) / scl
    if returned:
        if scl is None:
            scl = torch.tensor(float(a.numel() if ax is None
                                     else a.shape[ax]), dtype=out.dtype,
                               device=out.device)
        return out, torch.broadcast_to(scl.to(out.dtype), out.shape)
    return out


@register("_npi_bitwise_or", num_inputs=2, differentiable=False,
          aliases=("bitwise_or",))
def _bitwise_or(x1, x2):
    return torch.bitwise_or(*_promoted(x1, x2))


@register("_npi_bitwise_or_scalar", num_inputs=1, differentiable=False)
def _bitwise_or_scalar(x, scalar=0):
    return torch.bitwise_or(*_promoted(x, int(scalar)))


@register("_npi_bitwise_xor", num_inputs=2, differentiable=False,
          aliases=("bitwise_xor",))
def _bitwise_xor(x1, x2):
    return torch.bitwise_xor(*_promoted(x1, x2))


@register("_npi_bitwise_xor_scalar", num_inputs=1, differentiable=False)
def _bitwise_xor_scalar(x, scalar=0):
    return torch.bitwise_xor(*_promoted(x, int(scalar)))


@register("_npi_lcm_scalar", num_inputs=1, differentiable=False)
def _lcm_scalar(x, scalar=1):
    return torch.lcm(*_promoted(x, int(scalar))).abs()


@register("_npi_lcm", num_inputs=2, differentiable=False, aliases=("lcm",))
def _lcm(x1, x2):
    return torch.lcm(*_promoted(x1, x2)).abs()


@register("_npi_deg2rad", num_inputs=1)
def _deg2rad(x):
    return torch.deg2rad(*_inexact(x))


@register("_npi_rad2deg", num_inputs=1)
def _rad2deg(x):
    return torch.rad2deg(*_inexact(x))


@register("_npi_nan_to_num", num_inputs=1)
def _nan_to_num(x, nan=0.0, posinf=None, neginf=None, copy=True):
    if not x.is_floating_point():
        return x
    return torch.nan_to_num(x, nan=float(nan),
                            posinf=None if posinf is None else float(posinf),
                            neginf=None if neginf is None else float(neginf))


@register("_npi_diff", num_inputs=1, aliases=("diff",))
def _diff(x, n=1, axis=-1):
    return torch.diff(x, n=int(n), dim=int(axis))


@register("_npi_rot90", num_inputs=1, aliases=("rot90",))
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), [int(a) for a in axes])


@register("_np_roll", num_inputs=1, aliases=("roll",))
def _roll(x, shift=None, axis=None):
    sh = tuple(int(s) for s in shift) if isinstance(shift, (tuple, list)) \
        else int(shift)
    ax = _axis(axis)
    if ax is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, ax)


@register("_np_moveaxis", num_inputs=1, aliases=("moveaxis",))
def _moveaxis(x, source=None, destination=None):
    return torch.movedim(x, source, destination)


@register("_np_trace", num_inputs=1, aliases=("trace",))
def _trace(x, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(x, int(offset), int(axis1), int(axis2))
    return d.sum(-1, dtype=_sum_dtype(x))


@register("_np_diagonal", num_inputs=1, aliases=("diagonal",))
def _diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2))


@register("_np_diagflat", num_inputs=1, aliases=("diagflat",))
def _diagflat(x, k=0):
    return torch.diagflat(x, int(k))


def _moment(x, axis, ddof, keepdims):
    ax = _axis(axis)
    x = x.to(np_inexact(x.dtype))
    if ax is None:
        ax = tuple(range(x.ndim))
    return torch.var(x, dim=ax, correction=int(ddof), keepdim=bool(keepdims))


@register("_npi_std", num_inputs=1, aliases=("std",))
def _std(x, axis=None, ddof=0, keepdims=False):
    """The standard deviation with ``ddof`` (0: the biased one, NumPy's
    default; torch's default is the unbiased)."""
    return torch.sqrt(_moment(x, axis, ddof, keepdims))


@register("_npi_var", num_inputs=1, aliases=("var",))
def _var(x, axis=None, ddof=0, keepdims=False):
    return _moment(x, axis, ddof, keepdims)


@register("_npi_full_like", num_inputs=1, differentiable=False)
def _full_like(x, fill_value=0.0, dtype=None):
    dt = x.dtype if dtype is None else torch_dtype(dtype)
    return torch.full_like(x, float(fill_value), dtype=dt)


def _ctx(ctx):
    from .. import context

    return context.resolve(ctx)


def _linspace(start, stop, num, endpoint, dev):
    """``jnp.linspace`` in float64."""
    num = int(num)
    div = (num - 1) if endpoint else num
    i = torch.arange(num, dtype=torch.float64, device=dev)
    if div <= 0:
        return torch.full((num,), float(start), dtype=torch.float64,
                          device=dev)
    out = float(start) + i * ((float(stop) - float(start)) / div)
    if endpoint and num > 1:
        out[-1] = float(stop)
    return out


@register("_npi_logspace", num_inputs=0, differentiable=False)
def _logspace(start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
              dtype=None, ctx=None):
    lin = _linspace(start, stop, num, bool(endpoint), _ctx(ctx))
    out = torch.pow(torch.tensor(float(base), dtype=torch.float64,
                                 device=lin.device), lin)
    return out if dtype is None else out.to(torch_dtype(dtype))


@register("_npi_indices", num_inputs=0, differentiable=False)
def _indices(dimensions=(), dtype=None, ctx=None):
    dt = torch.int32 if dtype is None else torch_dtype(dtype)
    dev = _ctx(ctx)
    dims = tuple(int(d) for d in dimensions)
    if not dims:
        return torch.zeros((0,), dtype=dt, device=dev)
    grids = torch.meshgrid(*[torch.arange(d, dtype=dt, device=dev)
                             for d in dims], indexing="ij")
    return torch.stack(grids)


def _window(M, ctx, coeffs):
    """NumPy's cosine windows: ``sum(c_k cos(2 pi k i / (M - 1)))`` in
    float64; one point is ``[1.0]``, none an empty array."""
    n, dev = int(M), _ctx(ctx)
    if n < 1:
        return torch.zeros((0,), dtype=torch.float64, device=dev)
    if n == 1:
        return torch.ones((1,), dtype=torch.float64, device=dev)
    w = 2 * math.pi * torch.arange(n, dtype=torch.float64, device=dev) \
        / (n - 1)
    out = torch.full((n,), coeffs[0], dtype=torch.float64, device=dev)
    for k, c in enumerate(coeffs[1:], 1):
        out = out + c * torch.cos(k * w)
    return out


@register("_npi_hanning", num_inputs=0, differentiable=False)
def _hanning(M=1, dtype=None, ctx=None):  # noqa: N803 - numpy name
    return _window(M, ctx, (0.5, -0.5))


@register("_npi_hamming", num_inputs=0, differentiable=False)
def _hamming(M=1, dtype=None, ctx=None):  # noqa: N803 - numpy name
    return _window(M, ctx, (0.54, -0.46))


@register("_npi_blackman", num_inputs=0, differentiable=False)
def _blackman(M=1, dtype=None, ctx=None):  # noqa: N803 - numpy name
    return _window(M, ctx, (0.42, -0.5, 0.08))


@register("_npi_column_stack", aliases=("column_stack",))
def _column_stack(*arrays):
    return torch.column_stack(_promoted(*arrays))


@register("_npi_vstack", aliases=("vstack",))
def _vstack(*arrays):
    return torch.vstack(_promoted(*arrays))


@register("_npi_dstack", aliases=("dstack",))
def _dstack(*arrays):
    return torch.dstack(_promoted(*arrays))


@register("_npi_solve", num_inputs=2, aliases=("linalg_solve",))
def _solve(a, b):
    a, b = _inexact(a, b)
    if b.ndim == a.ndim - 1:  # a stack of vectors
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


@register("_npi_tensorinv", num_inputs=1, no_trace=True,
          differentiable=False)
def _tensorinv(a, ind=2):
    return torch.linalg.tensorinv(*_inexact(a), ind=int(ind))


@register("_npi_tensorsolve", num_inputs=2, no_trace=True,
          differentiable=False)
def _tensorsolve(a, b, a_axes=None):
    a, b = _inexact(a, b)
    return torch.linalg.tensorsolve(
        a, b, dims=None if a_axes is None else tuple(a_axes))


@register("_npi_svd", num_inputs=1, num_outputs=3, no_trace=True,
          differentiable=False, aliases=("linalg_gesvd",))
def _svd(a):
    u, s, vt = torch.linalg.svd(*_inexact(a), full_matrices=False)
    return u, s, vt


@register("_npi_bincount", num_inputs=1, differentiable=False,
          no_trace=True, aliases=("bincount",))
def _bincount(x, minlength=0, weights=None):
    """NumPy's: int64 counts, or float64 sums of the weights."""
    w = None if weights is None else _like(weights, x.device).to(
        torch.float64)
    return torch.bincount(x.to(torch.int64).reshape(-1), weights=w,
                          minlength=int(minlength))


@register("_npi_delete", num_inputs=1, differentiable=False, no_trace=True)
def _delete(arr, obj=None, start=None, stop=None, step=None, axis=None):
    """``numpy.delete``: the entries ``obj`` (an index, a list of them or
    the slice ``start:stop:step``) removed along ``axis`` (of the
    flattened array where it is None)."""
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis = int(axis)
    n = arr.shape[axis]
    keep = torch.ones(n, dtype=torch.bool, device=arr.device)
    if obj is None and start is not None:
        idx = range(n)[slice(int(start), None if stop is None else int(stop),
                             None if step is None else int(step))]
        keep[list(idx)] = False
    else:
        idx = [int(i) for i in obj] if isinstance(obj, (tuple, list)) \
            else [int(obj)]
        keep[torch.tensor(idx, dtype=torch.int64, device=arr.device)] = False
    return arr.index_select(axis, torch.nonzero(keep).reshape(-1))


@register("_npi_boolean_mask_assign_scalar", num_inputs=2)
def _boolean_mask_assign_scalar(data, mask, value=0.0):
    v, d = _promoted(float(value), data)
    return torch.where(mask.to(torch.bool), v, d)


@register("_npi_boolean_mask_assign_tensor", num_inputs=3)
def _boolean_mask_assign_tensor(data, mask, value):
    v, d = _promoted(value, data)
    return torch.where(mask.to(torch.bool), v, d)


@register("_npi_share_memory", num_inputs=2, differentiable=False,
          no_trace=True)
def _share_memory(a, b):
    """Whether ``a`` and ``b`` view one storage (``np.shares_memory``).
    The reference's arrays never alias, so it always answers False; the
    port's views do."""
    same = a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    return torch.tensor(bool(same) and a.numel() > 0 and b.numel() > 0,
                        device=a.device)


def _size(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


@register("_npi_normal_n", num_inputs=0, differentiable=False)
def _normal_n(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    from ..random import generator

    dev = _ctx(ctx)
    z = torch.randn(_size(size), generator=generator(dev), device=dev,
                    dtype=torch.float64)
    return float(loc) + float(scale) * z


@register("_npi_uniform_n", num_inputs=0, differentiable=False)
def _uniform_n(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    from ..random import generator

    dev = _ctx(ctx)
    u = torch.rand(_size(size), generator=generator(dev), device=dev,
                   dtype=torch.float64)
    return float(low) + u * (float(high) - float(low))


@register("_npi_choice", num_inputs=0, differentiable=False)
def _choice(a=0, size=None, replace=True, weights=None, ctx=None):
    """Draws of ``range(a)``, uniform or by ``weights``, with or without
    replacement (int64, as ``jax.random.choice`` over ``arange(a)``)."""
    from ..random import generator

    dev = _ctx(ctx)
    shape = _size(size)
    n = 1
    for d in shape:
        n *= d
    gen = generator(dev)
    if weights is None and replace:
        out = torch.randint(0, int(a), shape, generator=gen, device=dev)
        return out.to(torch.int64)
    p = torch.ones(int(a), dtype=torch.float64, device=dev) \
        if weights is None else _like(weights, dev).to(torch.float64)
    out = torch.multinomial(p, n, replacement=bool(replace), generator=gen)
    return out.reshape(shape).to(torch.int64)


# -- remaining visible-name tail ---------------------------------------------

for _np_name, _target in (("_np_broadcast_to", "broadcast_to"),
                          ("_np_cumsum", "cumsum"),
                          ("_np_diag", "diag"),
                          ("_np_dot", "dot"),
                          ("_np_max", "max"),
                          ("_np_min", "min"),
                          ("_np_prod", "prod"),
                          ("_np_reshape", "reshape"),
                          ("_np_squeeze", "squeeze"),
                          ("_np_sum", "sum"),
                          ("_np_transpose", "transpose"),
                          ("_rnn_param_concat", "concat"),
                          ("_contrib_SparseEmbedding", "Embedding")):
    if _target in OPS and _np_name not in OPS:
        alias(_np_name, _target)


@register("_image_to_tensor", num_inputs=1, aliases=("to_tensor",))
def _image_to_tensor(x):
    """HWC (or NHWC) in [0, 255] to CHW (NCHW) float32 in [0, 1]."""
    x = x.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if x.ndim == 3 else x.permute(0, 3, 1, 2)


@register("_image_normalize", num_inputs=1)
def _image_normalize(x, mean=(0.0,), std=(1.0,)):
    """Per-channel ``(x - mean) / std`` of CHW/NCHW float images."""
    shape = (-1, 1, 1) if x.ndim == 3 else (1, -1, 1, 1)
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - m.reshape(shape)) / s.reshape(shape)


@register("_image_resize", num_inputs=1)
def _image_resize(x, size=None, keep_ratio=False, interp=1):
    """HWC/NHWC images resized to ``size`` (``w`` or ``(w, h)``) as
    ``jax.image.resize`` does: half-pixel centres, bilinear with an
    antialiased downscale (``interp`` 1) or nearest (0), computed in
    float32 and cast back to the input's type (truncating, for uint8)."""
    if isinstance(size, (tuple, list)):
        w, h = int(size[0]), int(size[1])
    else:
        w = h = int(size)
    nchw = x.to(torch.float32)
    nchw = nchw.permute(2, 0, 1)[None] if x.ndim == 3 \
        else nchw.permute(0, 3, 1, 2)
    if int(interp) == 0:
        out = torch.nn.functional.interpolate(nchw, size=(h, w),
                                              mode="nearest-exact")
    else:
        out = resize_bilinear(nchw, h, w)
    out = out[0].permute(1, 2, 0) if x.ndim == 3 else out.permute(0, 2, 3, 1)
    return out.to(x.dtype)


@register("_image_crop", num_inputs=1)
def _image_crop(x, x_=0, y=0, width=1, height=1, x0=None, y0=None):
    """The ``width`` x ``height`` window at (``x0``/``x_``, ``y0``/``y``)
    of HWC/NHWC images."""
    left = int(x0 if x0 is not None else x_)
    top = int(y0 if y0 is not None else y)
    if x.ndim == 3:
        return x[top:top + int(height), left:left + int(width), :]
    return x[:, top:top + int(height), left:left + int(width), :]


@register("cast_storage", num_inputs=1, differentiable=False,
          no_trace=True)
def _cast_storage(data, stype="default"):
    """Dense arrays pass through for ``"default"``; sparse storage types
    are not at the op layer (the reference raises alike)."""
    if stype in ("default", None):
        return data
    raise NotImplementedError(
        "cast_storage to %r at the op layer: use "
        "ndarray.sparse.cast_storage on NDArray inputs (sparse formats "
        "carry python-side index structure)" % stype)


@register("_square_sum", num_inputs=1, differentiable=False)
def _square_sum(data, axis=None, keepdims=False):
    ax = tuple(range(data.ndim)) if axis is None else int(axis)
    return torch.sum(torch.square(data), dim=ax, keepdim=bool(keepdims),
                     dtype=_sum_dtype(data))


def _adamw_moments(g, m, v, beta1, beta2, rescale_grad, clip_gradient):
    g = g * float(rescale_grad)
    if float(clip_gradient) > 0:
        g = torch.clamp(g, -float(clip_gradient), float(clip_gradient))
    nm = float(beta1) * m + (1 - float(beta1)) * g
    nv = float(beta2) * v + (1 - float(beta2)) * torch.square(g)
    return nm, nv


@register("_multi_adamw_update", differentiable=False, num_outputs=None)
def _multi_adamw_update(*arrays, num_weights=None, lrs=(), wds=(), etas=(),
                        beta1=0.9, beta2=0.999, epsilon=1e-8,
                        rescale_grad=1.0, clip_gradient=-1.0):
    """AdamW over groups of (weight, grad, mean, var): returns (weight,
    mean, var) of each.  ``etas[i]`` scales both the Adam step and the
    weight decay; the gradient is rescaled before it is clipped."""
    out = []
    for i in range(len(arrays) // 4):
        w, g, m, v = arrays[4 * i:4 * i + 4]
        nm, nv = _adamw_moments(g, m, v, beta1, beta2, rescale_grad,
                                clip_gradient)
        w = w - float(etas[i]) * (
            float(lrs[i]) * nm / (torch.sqrt(nv) + float(epsilon))
            + float(wds[i]) * w)
        out.extend([w, nm, nv])
    return tuple(out)


@register("_multi_mp_adamw_update", differentiable=False, num_outputs=None)
def _multi_mp_adamw_update(*arrays, num_weights=None, lrs=(), wds=(),
                           etas=(), beta1=0.9, beta2=0.999, epsilon=1e-8,
                           rescale_grad=1.0, clip_gradient=-1.0):
    """The mixed-precision form: groups of (weight, grad, mean, var,
    weight32); the update runs on the float32 master, which is returned
    as the fourth output of its group and cast to the weight's type as
    the first."""
    out = []
    for i in range(len(arrays) // 5):
        w, g, m, v, w32 = arrays[5 * i:5 * i + 5]
        nm, nv = _adamw_moments(g.to(torch.float32), m, v, beta1, beta2,
                                rescale_grad, clip_gradient)
        nw32 = w32 - float(etas[i]) * (
            float(lrs[i]) * nm / (torch.sqrt(nv) + float(epsilon))
            + float(wds[i]) * w32)
        out.extend([nw32.to(w.dtype), nm, nv, nw32])
    return tuple(out)


@register("_contrib_calibrate_entropy", num_inputs=2, num_outputs=2,
          differentiable=False, no_trace=True)
def _calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """The KL-optimal threshold of a histogram (``calibrate.cc``): the
    search of ``contrib.quantization``, on the host as there."""
    from ..contrib.quantization import _entropy_threshold_from_hist

    t = _entropy_threshold_from_hist(hist.detach().cpu().numpy(),
                                     hist_edges.detach().cpu().numpy(),
                                     int(num_quantized_bins))
    return (torch.tensor(-t, dtype=torch.float32, device=hist.device),
            torch.tensor(t, dtype=torch.float32, device=hist.device))
