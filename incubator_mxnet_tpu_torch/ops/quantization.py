"""INT8 quantization ops (port of ``incubator_mxnet_tpu/ops/quantization.py``).

The reference computes its int8 products in XLA (``lax.dot_general`` and
``lax.conv_general_dilated`` with ``preferred_element_type=int32``), not
in Pallas; here they are ``torch._int_mm`` (int8 x int8 -> int32, exact
accumulation), on the card and on the CPU.  A convolution is an im2col:
the int8 windows are gathered with ``Tensor.unfold`` (no float detour)
and multiplied per group.  On the card ``_int_mm`` takes more than 16
rows and inner and outer widths that are multiples of 8; the operands
are padded with zero rows and columns (exact) and the padding sliced
off.  A refused product raises: nothing falls back to a float product.

Quantization convention (the reference's): symmetric int8 with scale
``127 / max(|min|, |max|)``, zero-point free.

Every division that decides a code divides by a tensor on the operand's
device.  On the card PyTorch divides by a Python number by multiplying
with its reciprocal, and ``number / tensor`` is ``reciprocal() *
number`` on every device; either can move a code at a rounding edge away
from the reference's.  ``torch.round`` rounds half to even, as
``jnp.rint`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["dequantize_tensor", "quantize_tensor", "symmetric_quantize",
           "int8_matmul", "int8_conv2d"]

_F32 = torch.float32


def _const(v, like):
    """``v`` as a 0-d f32 tensor on ``like``'s device (a divisor or a
    bound that must not go through PyTorch's Python-number paths), made
    by a fill on that device, so a CUDA-graph capture may call it."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=_F32)
    return torch.full((), float(v), dtype=_F32, device=like.device)


def _div(num, den):
    """``num / den`` as one IEEE division of two tensors on the device of
    whichever of them is a tensor."""
    like = den if isinstance(den, torch.Tensor) else num
    return _const(num, like) / _const(den, like)


def _upcast(x):
    """``x`` promoted as ``x * f32_scalar_array`` promotes in JAX: f64
    stays, every narrower type computes in f32."""
    return x if x.dtype == torch.float64 else x.to(_F32)


def _to_int8(real, qmax):
    """``clip(rint(real), -qmax, qmax)`` as int8 codes."""
    return torch.clamp(torch.round(real), -qmax, qmax).to(torch.int8)


def symmetric_quantize(w, qmax=127.0):
    """Symmetric per-tensor quantization: ``(int8 codes, 0-d f32 amax)``
    with scale ``qmax / amax`` (reference ``:24``).

    The reference's guards: an all-zero or non-finite tensor gives zero
    codes and ``amax = 0`` (so dequantizing it gives exact zeros), the
    divisor is clamped to 2^-126, and non-finite codes are zeroed."""
    w = torch.as_tensor(w)
    qm = _const(qmax, w)
    zero = _const(0.0, w)
    amax = w.abs().max().to(_F32)
    ok = torch.isfinite(amax) & (amax > 0)
    amax = torch.where(ok, amax, zero)
    scale = torch.where(ok, qm / torch.maximum(amax, _const(2.0 ** -126, w)),
                        _const(1.0, w))
    q = torch.round(w.to(_F32) * scale)
    q = torch.where(torch.isfinite(q), q, zero)
    q = torch.clamp(q, -qm, qm).to(torch.int8)
    return q, amax


def quantize_tensor(w):
    """Symmetric per-tensor int8 of one weight, ``(q_int8, amax_f32)``:
    the serving tier's load-time quantization (reference ``:52``)."""
    return symmetric_quantize(w, qmax=127.0)


def dequantize_tensor(q, amax, dtype=_F32):
    """Inverse of :func:`quantize_tensor`: ``q * (amax / 127)`` cast to
    ``dtype`` (reference ``:68``)."""
    amax = torch.as_tensor(amax)
    return (q.to(_F32) * _div(amax, 127.0)).to(dtype)


def _range_scale(min_r, max_r):
    amax = torch.maximum(torch.abs(min_r), torch.abs(max_r))
    return torch.where(amax > 0, _div(127.0, amax), _const(1.0, amax))


def _check_out_type(out_type):
    if str(out_type) not in ("int8", "auto"):
        raise NotImplementedError(
            "out_type=%r: only symmetric int8 quantization is implemented "
            "(the reference's affine uint8 encoding is not)" % (out_type,))


# ---------------------------------------------------------------------------
# the int8 products
# ---------------------------------------------------------------------------

def _round_up(n, m):
    return -(-n // m) * m


def _padded_int_mm(a, w):
    """``torch._int_mm(a, w.T)`` with ``a``'s rows padded to at least 24
    and a multiple of 8 and the inner and outer widths to multiples of 8,
    all with zeros (exact), the result sliced back: the shapes the card's
    ``_int_mm`` takes."""
    m, k = a.shape
    n = w.shape[0]
    mp = max(_round_up(m, 8), 24)
    kp, np_ = _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_matmul(a, w):
    """``a @ w.T`` for int8 ``a`` (M, K) and ``w`` (N, K), accumulated
    exactly in int32: ``torch._int_mm``, on the card through
    :func:`_padded_int_mm` (module note)."""
    m, k = a.shape
    n = w.shape[0]
    if a.device.type == "meta":
        return torch.empty((m, n), dtype=torch.int32, device="meta")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
    if a.device.type == "cuda":
        return _padded_int_mm(a, w)
    return torch._int_mm(a.contiguous(), w.contiguous().t())


def int8_conv2d(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), groups=1):
    """NCHW int8 convolution with OIHW int8 filters, int32 accumulation:
    an im2col of int8 windows (``Tensor.unfold``) and one
    :func:`int8_matmul` per group."""
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    ekh, ekw = dh * (kh - 1) + 1, dw * (kw - 1) + 1
    oh = (h + 2 * ph - ekh) // sh + 1
    ow = (wd + 2 * pw - ekw) // sw + 1
    if x.device.type == "meta":
        return torch.empty((n, o, oh, ow), dtype=torch.int32, device="meta")
    if c != cg * groups or o % groups:
        raise ValueError("quantized_conv: %d input channels, %d filters of "
                         "%d channels in %d groups" % (c, o, cg, groups))
    xp = F.pad(x, (pw, pw, ph, ph)) if (ph or pw) else x
    win = xp.unfold(2, ekh, sh).unfold(3, ekw, sw)  # N, C, OH, OW, ekh, ekw
    if dh != 1 or dw != 1:
        win = win[..., ::dh, ::dw]
    og = o // groups
    outs = []
    for g in range(groups):
        cols = win[:, g * cg:(g + 1) * cg].permute(0, 2, 3, 1, 4, 5) \
            .reshape(n * oh * ow, cg * kh * kw)
        outs.append(int8_matmul(cols, w[g * og:(g + 1) * og]
                                .reshape(og, cg * kh * kw)))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# the registered ops (reference :86-214)
# ---------------------------------------------------------------------------

@register("_contrib_quantize", num_inputs=3, num_outputs=3,
          differentiable=False)
def _quantize(data, min_range, max_range, out_type="int8"):
    """float -> int8 with an explicit range (quantize.cc)."""
    _check_out_type(out_type)
    scale = _range_scale(min_range, max_range)
    q = _to_int8(_upcast(data) * scale, 127)
    amax = torch.maximum(torch.abs(min_range), torch.abs(max_range))
    return q, -amax, amax


@register("_contrib_quantize_v2", num_inputs=1, num_outputs=3,
          differentiable=False)
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """float -> int8; the range from the calibration attributes or the
    data itself (quantize_v2.cc)."""
    _check_out_type(out_type)
    if min_calib_range is not None and max_calib_range is not None:
        min_r = _const(min_calib_range, data)
        max_r = _const(max_calib_range, data)
    else:
        min_r = data.min().to(_F32)
        max_r = data.max().to(_F32)
    amax = torch.maximum(torch.abs(min_r), torch.abs(max_r))
    scale = torch.where(amax > 0, _div(127.0, amax), _const(1.0, amax))
    q = _to_int8(_upcast(data) * scale, 127)
    return q, -amax, amax


@register("_contrib_dequantize", num_inputs=3, differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32"):
    """int8 (or an int32 accumulator) -> float (dequantize.cc)."""
    return data.to(_F32) / _range_scale(min_range, max_range)


@register("_contrib_requantize", num_inputs=3, num_outputs=3,
          differentiable=False)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """int32 accumulator -> int8 with a narrower range (requantize.cc):
    the calibrated one, else the data's own."""
    in_scale = _div(torch.maximum(torch.abs(min_range), torch.abs(max_range)),
                    127.0)
    real = data.to(_F32) * in_scale
    if min_calib_range is not None and max_calib_range is not None:
        amax = _const(max(abs(float(min_calib_range)),
                          abs(float(max_calib_range))), real)
    else:
        amax = torch.abs(real).max()
    scale = torch.where(amax > 0, _div(127.0, amax), _const(1.0, amax))
    q = _to_int8(real * scale, 127)
    return q, -amax, amax


@register("_contrib_quantized_elemwise_add", num_inputs=6, num_outputs=3,
          differentiable=False)
def _quantized_elemwise_add(a, b, min_a, max_a, min_b, max_b):
    """int8 + int8 -> int8 residual add with the scales aligned
    (quantized_elemwise_add.cc); the output range is the sum of the
    input ranges."""
    sa = _div(torch.maximum(torch.abs(min_a), torch.abs(max_a)), 127.0)
    sb = _div(torch.maximum(torch.abs(min_b), torch.abs(max_b)), 127.0)
    amax_out = sa * 127.0 + sb * 127.0
    real = a.to(_F32) * sa + b.to(_F32) * sb
    scale = torch.where(amax_out > 0, _div(127.0, amax_out),
                        _const(1.0, amax_out))
    q = _to_int8(real * scale, 127)
    return q, -amax_out, amax_out


def _add_bias(acc, bias, min_bias, max_bias, out_scale, shape):
    """The int8 bias rescaled into the accumulator's scale and added."""
    b_scale = _range_scale(min_bias, max_bias)
    b = torch.round(bias.to(_F32) / b_scale * out_scale)
    return acc + b.to(torch.int32).reshape(shape)


@register("_contrib_quantized_fully_connected", num_inputs=9, num_outputs=3,
          differentiable=False)
def _quantized_fully_connected(data, weight, bias, min_data, max_data,
                               min_weight, max_weight, min_bias=None,
                               max_bias=None, num_hidden=0, no_bias=False,
                               flatten=True, **ignored):
    """int8 x int8 -> int32 dense layer (quantized_fully_connected.cc):
    the int32 accumulator and its float range."""
    x = data
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    lead = tuple(x.shape[:-1])
    acc = int8_matmul(x.reshape(-1, x.shape[-1]).to(torch.int8),
                      weight.to(torch.int8)).reshape(lead + (weight.shape[0],))
    out_scale = _range_scale(min_data, max_data) * \
        _range_scale(min_weight, max_weight)
    if bias is not None and not no_bias:
        acc = _add_bias(acc, bias, min_bias, max_bias, out_scale, (-1,))
    # declared so that dequantize's x * amax / 127 recovers the floats
    amax = _div(127.0, out_scale)
    return acc, -amax, amax


@register("_contrib_quantized_conv", num_inputs=9, num_outputs=3,
          differentiable=False)
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias=None, max_bias=None, kernel=None,
                    stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                    num_filter=0, num_group=1, no_bias=False,
                    layout="NCHW", **ignored):
    """int8 convolution with int32 accumulation (quantized_conv.cc)."""
    if layout != "NCHW":
        raise NotImplementedError(
            "quantized_conv only supports layout='NCHW', got %r" % (layout,))
    acc = int8_conv2d(data.to(torch.int8), weight.to(torch.int8),
                      stride=tuple(int(s) for s in stride),
                      pad=tuple(int(p) for p in pad),
                      dilate=tuple(int(d) for d in dilate),
                      groups=int(num_group))
    out_scale = _range_scale(min_data, max_data) * \
        _range_scale(min_weight, max_weight)
    if bias is not None and not no_bias:
        acc = _add_bias(acc, bias, min_bias, max_bias, out_scale,
                        (1, -1, 1, 1))
    amax = _div(127.0, out_scale)
    return acc, -amax, amax
