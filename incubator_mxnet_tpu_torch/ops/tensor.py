"""Shape, indexing and initialization operators (port of the part of
``incubator_mxnet_tpu/ops/tensor.py`` that ``NDArray`` and the ``nd``
factories call).

``Reshape`` keeps MXNet's special codes (0 copy, -1 infer, -2 copy the
rest, -3 merge two, -4 split one) and ``reverse``.  Slicing takes
negative steps (torch's basic slicing does not, so those axes gather).
The zero-input ops take ``ctx`` and resolve it as every entry point of the
port does: ``None`` is the default CUDA card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import context
from ..base import torch_dtype
from .registry import register

# ---------------------------------------------------------------------------
# reshape family (tensor.py :21-100)
# ---------------------------------------------------------------------------


def _mx_shape(src, shape):
    """The target shape of MXNet's Reshape codes over ``src``
    (``_mx_reshape``; -1 entries are left for torch to infer)."""
    src = list(src)
    out = []
    i = 0
    j = 0
    shape = list(shape)
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    return tuple(out)


@register("Reshape", num_inputs=1, aliases=("reshape",))
def _reshape(data, shape=None, reverse=False, **ignored):
    if reverse:
        rev = data.reshape(tuple(data.shape)[::-1])
        out = rev.reshape(_mx_shape(rev.shape, list(shape)[::-1]))
        return out.reshape(tuple(out.shape)[::-1])
    return data.reshape(_mx_shape(data.shape, shape))


@register("Flatten", num_inputs=1, aliases=("flatten",))
def _flatten(data):
    return data.reshape(data.shape[0], -1)


@register("transpose", num_inputs=1)
def _transpose(data, axes=None):
    if axes is None or (isinstance(axes, (tuple, list)) and len(axes) == 0):
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(*axes)


@register("expand_dims", num_inputs=1)
def _expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze", num_inputs=1)
def _squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, dim=axis)


@register("swapaxes", num_inputs=1, aliases=("SwapAxis",))
def _swapaxes(data, dim1=0, dim2=0):
    return torch.transpose(data, dim1, dim2)


# ---------------------------------------------------------------------------
# slicing (tensor.py :111-140)
# ---------------------------------------------------------------------------


def _take_slices(data, slices):
    """``data[slices]`` with negative steps allowed: positive-step axes
    slice, negative-step axes gather their indices."""
    basic = []
    gathers = []
    for axis, sl in enumerate(slices):
        if sl.step is not None and sl.step < 0:
            basic.append(slice(None))
            idx = range(*sl.indices(data.shape[axis]))
            gathers.append((axis, torch.tensor(list(idx), dtype=torch.long,
                                               device=data.device)))
        else:
            basic.append(sl)
    out = data[tuple(basic)]
    for axis, idx in gathers:
        out = torch.index_select(out, axis, idx)
    return out


def _canon_slice(begin, end, step, shape):
    slices = []
    for i in range(len(shape)):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = (step[i] if i < len(step) else None) if step else None
        slices.append(slice(b, e, s))
    return slices


@register("slice", num_inputs=1, aliases=("crop",))
def _slice(data, begin=(), end=(), step=()):
    return _take_slices(data, _canon_slice(list(begin), list(end),
                                           list(step or ()), data.shape))


@register("slice_axis", num_inputs=1)
def _slice_axis(data, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


# ---------------------------------------------------------------------------
# broadcast, tile, repeat, pad, reverse (tensor.py :142-194)
# ---------------------------------------------------------------------------


@register("broadcast_to", num_inputs=1)
def _broadcast_to(data, shape=()):
    tgt = tuple(d if s == 0 else s for s, d in zip(shape, data.shape)) \
        if len(shape) == data.ndim else tuple(shape)
    return torch.broadcast_to(data, tgt)


@register("broadcast_like", num_inputs=2)
def _broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = rhs.shape[ra]
    return torch.broadcast_to(lhs, tuple(tgt))


@register("tile", num_inputs=1)
def _tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat", num_inputs=1)
def _repeat(data, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


_PAD_MODE = {"edge": "replicate", "reflect": "reflect"}


@register("pad", num_inputs=1, aliases=("Pad",))
def _pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is MXNet's flat (before, after) list, one pair per
    axis from the first.  ``edge`` and ``reflect`` pad only trailing axes
    of a batched tensor (torch's rule, which covers MXNet's: its pad
    takes 4-D/5-D input and pads the spatial axes)."""
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    flat = []
    for before, after in reversed(pairs):
        flat += [before, after]
    if mode == "constant":
        return F.pad(data, flat, value=constant_value)
    if mode not in _PAD_MODE:
        raise ValueError("unknown pad mode %r" % mode)
    padded = [i for i, p in enumerate(pairs) if p != (0, 0)]
    first = padded[0] if padded else data.ndim
    if first == 0 or data.ndim - first > 3:
        raise ValueError("pad mode %r pads the last 1-3 axes of a batched "
                         "tensor, got pad_width %s for %d axes"
                         % (mode, tuple(pad_width), data.ndim))
    return F.pad(data, flat[:2 * (data.ndim - first)], mode=_PAD_MODE[mode])


@register("reverse", num_inputs=1, aliases=("flip",))
def _reverse(data, axis=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=axis)


@register("Concat", aliases=("concat",))
def _concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


@register("SliceChannel", aliases=("split",), num_inputs=1)
def _split(data, num_outputs=2, axis=1, squeeze_axis=False):
    if data.shape[axis] % num_outputs:
        raise ValueError("axis %d of size %d does not split into %d equal "
                         "parts" % (axis, data.shape[axis], num_outputs))
    parts = torch.tensor_split(data, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=axis) for p in parts]
    return tuple(parts)


# ---------------------------------------------------------------------------
# indexing (tensor.py :232-278)
# ---------------------------------------------------------------------------


@register("take", num_inputs=2)
def _take(a, indices, axis=0, mode="clip"):
    idx = indices.to(torch.long)
    n = a.shape[axis]
    idx = torch.remainder(idx, n) if mode == "wrap" \
        else torch.clamp(idx, 0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                       + tuple(a.shape[axis + 1:]))


@register("pick", num_inputs=2)
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s entry at ``index`` along ``axis``; indices are clipped
    into range (the reference clips whatever ``mode`` says)."""
    idx = index.to(torch.long).clamp(0, data.shape[axis] - 1)
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return out if keepdims else out.squeeze(axis)


@register("one_hot", num_inputs=1, differentiable=False)
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of out-of-range indices are all ``off_value``, as
    ``jax.nn.one_hot`` gives."""
    hot = indices.to(torch.long)[..., None] == torch.arange(
        depth, device=indices.device)
    oh = hot.to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("where", num_inputs=3)
def _where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range: NaN for a floating
    dtype, the most negative value for a signed one, the largest for an
    unsigned one."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("Embedding", num_inputs=2)
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at ``data`` (any dtype, truncated to an integer
    as the reference's ``astype(int32)``): ``jnp.take(weight, idx,
    axis=0)``, so an index in [-input_dim, 0) counts from the end and one
    outside [-input_dim, input_dim) gives a row of NaN (of the most
    negative integer for an integer weight), whose gradient is dropped.
    ``sparse_grad`` is accepted; the gradient stays dense, as in the
    reference."""
    n = weight.shape[0]
    idx = data.to(torch.int32).to(torch.long)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.remainder(idx, n), 0)
    rows = torch.nn.functional.embedding(safe, weight)
    return torch.where(valid.unsqueeze(-1), rows, torch.full(
        (), _fill_value(weight.dtype), dtype=weight.dtype,
        device=weight.device))


# ---------------------------------------------------------------------------
# init ops (tensor.py :334-370)
# ---------------------------------------------------------------------------


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register("_zeros", num_inputs=0, differentiable=False, aliases=("zeros",))
def _zeros(shape=(), ctx=None, dtype="float32"):
    return torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                       device=context.resolve(ctx))


@register("_ones", num_inputs=0, differentiable=False, aliases=("ones",))
def _ones(shape=(), ctx=None, dtype="float32"):
    return torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                      device=context.resolve(ctx))


@register("_full", num_inputs=0, differentiable=False, aliases=("full",))
def _full(shape=(), value=0.0, ctx=None, dtype="float32"):
    return torch.full(_shape(shape), value, dtype=torch_dtype(dtype),
                      device=context.resolve(ctx))


@register("_arange", num_inputs=0, differentiable=False, aliases=("arange",))
def _arange(start=0, stop=None, step=1.0, repeat=1, ctx=None,
            dtype="float32", infer_range=False):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=context.resolve(ctx))
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("zeros_like", num_inputs=1, differentiable=False)
def _zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", num_inputs=1, differentiable=False)
def _ones_like(data):
    return torch.ones_like(data)
