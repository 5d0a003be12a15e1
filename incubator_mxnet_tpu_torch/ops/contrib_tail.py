"""Deformable convolution (port of the ``_contrib_DeformableConvolution``
op of ``incubator_mxnet_tpu/ops/contrib_tail.py``; the file's other ops
are ROADMAP Queue A item 3).

Each kernel tap samples the input at its position plus a fractional
offset, bilinearly (:func:`_bilinear_gather`), and the taps contract with
the weights one tap at a time, in the reference's order.  The reference
computes this with XLA gathers and einsums, no Pallas; here it is torch
gathers and products on the inputs' device, differentiable in the data,
the offsets, the weights and the bias.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _bilinear_gather(data, xs, ys):
    """``data`` (N, C, H, W) sampled at pixel coordinates ``xs``/``ys``
    (N, ...).  Each of the four corners counts only where it lies inside
    the image (else 0): not ``grid_sample``'s zero padding, whose corners
    are weighed on another coordinate convention."""
    n, c, h, w = data.shape
    out_shape = tuple(xs.shape[1:])
    xs = xs.reshape(n, -1)
    ys = ys.reshape(n, -1)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[:, None, :]
    wy = (ys - y0)[:, None, :]
    flat = data.reshape(n, c, h * w)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        # a corner outside (or at a NaN coordinate) reads pixel 0, weighed 0
        idx = torch.where(inside, yi * w + xi, 0).long()
        idx = idx[:, None, :].expand(n, c, -1)
        return torch.gather(flat, 2, idx) * inside.to(data.dtype)[:, None, :]

    out = (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx * (1 - wy)
           + tap(y0 + 1, x0) * (1 - wx) * wy + tap(y0 + 1, x0 + 1) * wx * wy)
    return out.reshape((n, c) + out_shape)


@register("_contrib_DeformableConvolution", num_inputs=None,
          aliases=("DeformableConvolution",))
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            num_filter=1, stride=(1, 1), pad=(0, 0),
                            dilate=(1, 1), num_deformable_group=1,
                            num_group=1, no_bias=False, workspace=1024,
                            layout=None):
    """Deformable convolution v1: data (N, C, H, W), offset (N, 2 * G *
    kh * kw, Ho, Wo) as (group, tap, (dy, dx)), weight (F, C, kh, kw);
    computed in float32, returned in the data's dtype."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(pad[0]), int(pad[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    g = int(num_deformable_group)
    n, c, h, w = data.shape
    f = int(num_filter)
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev = data.device
    base_y = torch.arange(ho, dtype=torch.float32, device=dev) * sh - ph
    base_x = torch.arange(wo, dtype=torch.float32, device=dev) * sw - pw
    gy, gx = torch.meshgrid(base_y, base_x, indexing="ij")
    dataf = data.float()
    off = offset.float().reshape(n, g, kh * kw, 2, ho, wo)
    cg = c // g
    out = torch.zeros((n, f, ho, wo), dtype=torch.float32, device=dev)
    wmat = weight.float()
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            sampled = torch.cat([
                _bilinear_gather(dataf[:, gi * cg:(gi + 1) * cg],
                                 gx[None] + j * dw + off[:, gi, t, 1],
                                 gy[None] + i * dh + off[:, gi, t, 0])
                for gi in range(g)], dim=1)
            out = out + torch.einsum("nchw,fc->nfhw", sampled,
                                     wmat[:, :, i, j])
    if bias is not None and not no_bias:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out.to(data.dtype)
