"""Shape, indexing, cast, initialization and sequence operators and the
regression heads (port of ``incubator_mxnet_tpu/ops/tensor.py``).

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


# ---------------------------------------------------------------------------
# the rest of the reference's tensor.py: space/depth, slices and splits,
# gathers and scatters, casts, init ops, sequence ops, numpy ops, the
# regression heads
# ---------------------------------------------------------------------------


@register("depth_to_space", num_inputs=1)
def _depth_to_space(data, block_size):
    b, c, h, w = data.shape
    bs = block_size
    x = data.reshape(b, bs, bs, c // (bs * bs), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth", num_inputs=1)
def _space_to_depth(data, block_size):
    b, c, h, w = data.shape
    bs = block_size
    x = data.reshape(b, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * bs * bs, h // bs, w // bs)


@register("slice_like", num_inputs=2)
def _slice_like(data, shape_like, axes=()):
    axes = list(axes) if axes else list(range(min(data.ndim,
                                                  shape_like.ndim)))
    idx = [slice(None)] * data.ndim
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("broadcast_axis", num_inputs=1, aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt))


@register("split_v2", num_inputs=1)
def _split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0):
    """``sections`` equal parts (which must divide the axis), else the
    parts between ``indices``; one output a part."""
    if sections:
        if data.shape[axis] % sections:
            raise ValueError("axis %d of size %d does not split into %d "
                             "equal parts" % (axis, data.shape[axis],
                                              sections))
        parts = torch.tensor_split(data, sections, dim=axis)
    else:
        parts = torch.tensor_split(data, list(indices), dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=axis) for p in parts]
    return tuple(parts)


def _wrap(idx, n):
    """Indices counted from the end where negative, as numpy's."""
    return torch.where(idx < 0, idx + n, idx)


@register("batch_take", num_inputs=2)
def _batch_take(a, indices):
    idx = _wrap(indices.to(torch.long), a.shape[1])
    return torch.take_along_dim(a, idx[:, None], dim=1)[:, 0]


def _nd_index(indices, shape):
    """The leading-axes index tuple of ``indices`` (M, ...): negative
    entries count from the end."""
    return tuple(_wrap(indices[i].to(torch.long), shape[i])
                 for i in range(indices.shape[0]))


@register("gather_nd", num_inputs=2)
def _gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``; an index out of range clamps
    to the axis, as JAX's gathers do."""
    idx = tuple(i.clamp(0, data.shape[k] - 1)
                for k, i in enumerate(_nd_index(indices, data.shape)))
    return data[idx]


@register("scatter_nd", num_inputs=2, differentiable=False)
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    out[_nd_index(indices, out.shape)] = data
    return out


@register("_scatter_set_nd", num_inputs=3, differentiable=False)
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    out = lhs.clone()
    out[_nd_index(indices, out.shape)] = rhs.to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# casts (tensor.py :296-322)
# ---------------------------------------------------------------------------


@register("Cast", num_inputs=1, aliases=("cast",))
def _cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("amp_cast", num_inputs=1)
def _amp_cast(data, dtype="float16"):
    """Floating data to ``dtype``; integer and boolean data (indices,
    masks) pass as they are, so a cast may sit on any input edge."""
    if not data.is_floating_point():
        return data
    return data.to(torch_dtype(dtype))


def _float_bits(dtype):
    return torch.finfo(dtype).bits if dtype.is_floating_point else 64


@register("amp_multicast")
def _amp_multicast(*args, num_outputs=None, cast_narrow=False):
    """Every input cast to the widest of their types (their promotion),
    or with ``cast_narrow`` to the narrowest floating one (the first of
    equal width)."""
    dtypes = [a.dtype for a in args]
    if cast_narrow:
        tgt = min(dtypes, key=_float_bits)
    else:
        tgt = dtypes[0]
        for d in dtypes[1:]:
            tgt = torch.promote_types(tgt, d)
    return tuple(a.to(tgt) for a in args)


# ---------------------------------------------------------------------------
# init ops and shape ops (tensor.py :358-383)
# ---------------------------------------------------------------------------


@register("_linspace", num_inputs=0, differentiable=False,
          aliases=("linspace",))
def _linspace(start=0, stop=1, num=50, endpoint=True, ctx=None,
              dtype="float32"):
    """``num`` points from ``start`` to ``stop`` (``stop`` left out
    without ``endpoint``), spaced in float64 and cast to ``dtype``."""
    num = int(num)
    n = num if endpoint else num + 1
    out = torch.linspace(float(start), float(stop), n, dtype=torch.float64,
                         device=context.resolve(ctx))
    return out[:num].to(torch_dtype(dtype))


@register("_eye", num_inputs=0, differentiable=False, aliases=("eye",))
def _eye(N=1, M=0, k=0, ctx=None, dtype="float32"):  # noqa: N803
    n, m = int(N), int(M) if M else int(N)
    dev = context.resolve(ctx)
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(m, device=dev)[None, :]
    return (cols - rows == int(k)).to(torch_dtype(dtype))


@register("shape_array", num_inputs=1, differentiable=False)
def _shape_array(data):
    """The shape as int64 (the reference runs with 64-bit types on)."""
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", num_inputs=1, differentiable=False)
def _size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


# ---------------------------------------------------------------------------
# sequence ops (tensor.py :388-438): time on axis 0 (or 1 where ``axis``
# says), lengths a float or integer vector over the batch
# ---------------------------------------------------------------------------


@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    lens = sequence_length.to(torch.int32)
    if axis == 0:
        mask = steps[:, None] < lens[None, :]
    else:
        mask = steps[None, :] < lens[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, -1)
    idx = _wrap(sequence_length.to(torch.int32).to(torch.long) - 1,
                data.shape[axis])
    if axis == 0:
        return torch.take_along_dim(
            data, idx.reshape((1, -1) + (1,) * (data.ndim - 2)), dim=0)[0]
    return torch.take_along_dim(
        data, idx.reshape((-1, 1) + (1,) * (data.ndim - 2)), dim=1)[:, 0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """The first ``length`` steps of each sequence reversed, the rest
    kept; always along axis 0, as the reference (``axis`` is accepted)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int32).to(torch.long)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = _wrap(rev, data.shape[0])
    return torch.take_along_dim(
        data, rev.reshape(tuple(rev.shape) + (1,) * (data.ndim - 2)), dim=0)


# ---------------------------------------------------------------------------
# numpy ops (tensor.py :441-464)
# ---------------------------------------------------------------------------


@register("_np_nonzero", num_inputs=1, differentiable=False)
def _np_nonzero(data, size=None):
    """The indices of the nonzero entries, (size, ndim) int64, padded
    with -1 (``size`` defaults to the element count): a shape known
    before the data, as the reference's ``jnp.nonzero(size=...)``."""
    size = size or data.numel()
    out = torch.full((size, data.ndim), -1, dtype=torch.int64,
                     device=data.device)
    if data.device.type == "meta":
        return out
    idx = torch.nonzero(data)[:size]
    out[:idx.shape[0]] = idx
    return out


@register("_np_unique", num_inputs=1, differentiable=False, no_trace=True)
def _np_unique(data, return_index=False, return_inverse=False,
               return_counts=False, axis=None):
    """``numpy.unique`` on the host, as the reference evaluates it (its
    shape depends on the data): the values in the data's dtype, the
    indices and counts int64, on the data's device."""
    import numpy as np

    outs = np.unique(data.detach().cpu().numpy(), return_index=return_index,
                     return_inverse=return_inverse,
                     return_counts=return_counts, axis=axis)
    if isinstance(outs, tuple):
        return tuple(torch.as_tensor(o, device=data.device) for o in outs)
    return torch.as_tensor(outs, device=data.device)


@register("tril", num_inputs=1)
def _tril(data, k=0):
    return torch.tril(data, diagonal=k)


# ---------------------------------------------------------------------------
# regression heads (tensor.py :470-505)
# ---------------------------------------------------------------------------


class _RegressionOutput(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ignores the head gradient and
    returns ``grad(fwd(data), label) * grad_scale / num_output`` in the
    data's dtype (a loss layer: ``regression_output-inl.h``), with
    ``num_output`` the features a sample, and no gradient for the
    label."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.fwd, ctx.grad, ctx.grad_scale = fwd, grad, grad_scale
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        num_output = data.numel() // data.shape[0] if data.ndim > 0 else 1
        dx = ctx.grad(ctx.fwd(data), label) * (ctx.grad_scale / num_output)
        dl = torch.zeros_like(label) if label.is_floating_point() else None
        return dx.to(data.dtype), dl, None, None, None


def _regression_output(data, label, grad_scale, fwd, grad):
    if label.shape != data.shape:
        label = label.reshape(data.shape)
    return _RegressionOutput.apply(data, label, fwd, grad, float(grad_scale))


def _identity(d):
    return d.clone()


def _residual(p, lab):
    return p - lab


@register("LinearRegressionOutput", num_inputs=2,
          aliases=("linear_regression_output",))
def _linreg_out(data, label, grad_scale=1.0):
    return _regression_output(data, label, grad_scale, _identity, _residual)


@register("LogisticRegressionOutput", num_inputs=2,
          aliases=("logistic_regression_output",))
def _logreg_out(data, label, grad_scale=1.0):
    return _regression_output(data, label, grad_scale, torch.sigmoid,
                              _residual)


@register("MAERegressionOutput", num_inputs=2,
          aliases=("mae_regression_output",))
def _maereg_out(data, label, grad_scale=1.0):
    return _regression_output(data, label, grad_scale, _identity,
                              lambda p, lab: torch.sign(p - lab))
