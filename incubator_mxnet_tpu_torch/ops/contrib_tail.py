"""The operator long tail (port of ``incubator_mxnet_tpu/ops/
contrib_tail.py``): the spatial warping family (``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``), ``Crop``, ``Correlation``,
the deformable convolution and deformable PS-ROI pooling, the RPN's
``Proposal``/``MultiProposal``, ``SyncBatchNorm``, the transformer's
``div_sqrt_dim`` and interleaved matmuls, ``fft``/``ifft``,
``count_sketch``, ``boolean_mask``, ``index_copy`` and ``index_array``.

The reference computes these with XLA gathers, einsums and loops, no
Pallas; here they are torch ops on the inputs' device.  Bilinear
sampling is one shared gather (:func:`_bilinear_gather`) for the whole
warping family.  ``Correlation`` shifts with a roll, which wraps around
the border where upstream MXNet pads with zeros, as the reference does.
``Proposal``'s greedy NMS builds the suppression matrix of its
candidates once and then makes at most ``rpn_post_nms_top_n`` picks on
the device, with no host read inside the loop.  ``boolean_mask``'s
output shape follows its data (``no_trace``).
"""
from __future__ import annotations

import math

import torch

from .nn import _batch_norm_aux_update, _batch_norm_op
from .registry import OPS, register

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


# -- GridGenerator / BilinearSampler / SpatialTransformer / Crop ------------

def _linspace64(n, dev):
    """``jnp.linspace(-1.0, 1.0, n)`` (float64 with 64-bit types on:
    ``-1 * (1 - s) + 1 * s``, the last point 1 itself), as float32; ``s``
    divides by a tensor, as on the CPU also on the card."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=torch.float32, device=dev)
    s = torch.arange(n - 1, dtype=torch.float64, device=dev) / torch.tensor(
        n - 1, dtype=torch.float64, device=dev)
    return torch.cat([-1.0 * (1 - s) + s, torch.ones(1, dtype=torch.float64,
                                                      device=dev)]).float()


@register("GridGenerator", num_inputs=1)
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """``affine``: (N, 6) parameters to an (N, 2, H, W) grid of normalised
    (x, y) in [-1, 1]; ``warp``: an (N, 2, H, W) flow added to the pixel
    grid, normalised."""
    dev = data.device
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3).float()
        gy, gx = torch.meshgrid(_linspace64(h, dev), _linspace64(w, dev),
                                indexing="ij")
        src = torch.stack([gx.reshape(-1), gy.reshape(-1),
                           torch.ones(h * w, device=dev)])
        return torch.matmul(theta, src).reshape(-1, 2, h, w).to(data.dtype)
    _, _, h, w = data.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx = data[:, 0].float() + gx
    fy = data[:, 1].float() + gy
    nx = 2.0 * fx / max(w - 1, 1) - 1.0
    ny = 2.0 * fy / max(h - 1, 1) - 1.0
    return torch.stack([nx, ny], dim=1).to(data.dtype)


@register("BilinearSampler", num_inputs=2)
def _bilinear_sampler(data, grid, cudnn_off=False):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo) of
    normalised (x, y); corners outside the image count 0."""
    _, _, h, w = data.shape
    xs = (grid[:, 0].float() + 1.0) * (w - 1) / 2.0
    ys = (grid[:, 1].float() + 1.0) * (h - 1) / 2.0
    return _bilinear_gather(data.float(), xs, ys).to(data.dtype)


@register("SpatialTransformer", num_inputs=2)
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    """An affine grid from ``loc`` (N, 6), then bilinear sampling."""
    return _bilinear_sampler(data, _grid_generator(
        loc, transform_type="affine", target_shape=target_shape))


@register("Crop", num_inputs=None, differentiable=True)
def _crop(*args, offset=(0, 0), h_w=(0, 0), num_args=0, center_crop=False):
    """``args[0]`` cropped to ``h_w`` or to ``args[1]``'s spatial shape, at
    ``offset`` or centred."""
    data = args[0]
    if len(args) > 1 and args[1] is not None:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (h - th) // 2, (w - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    return data[:, :, y0:y0 + th, x0:x0 + tw]


@register("Correlation", num_inputs=2)
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """The FlowNet correlation volume: for each displacement on the
    ``stride2`` grid within ``max_displacement``, the channel mean of
    ``data1`` times ``data2`` shifted (``-|d1 - d2|`` without
    ``is_multiply``), averaged over the ``kernel_size`` window.  The shift
    is a roll: it wraps around the border, as the reference's."""
    k, md = int(kernel_size), int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    padding = (pad, pad, pad, pad)
    d1 = torch.nn.functional.pad(data1.float(), padding)
    d2 = torch.nn.functional.pad(data2.float(), padding)
    r = md // s2
    planes = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = torch.roll(d2, shifts=(-dy * s2, -dx * s2), dims=(2, 3))
            prod = d1 * shifted if is_multiply else -torch.abs(d1 - shifted)
            summed = prod.mean(dim=1)
            if k > 1:
                summed = torch.nn.functional.avg_pool2d(
                    summed[:, None], k, stride=1, padding=k // 2,
                    count_include_pad=True)[:, 0]
            planes.append(summed)
    out = torch.stack(planes, dim=1)[:, :, ::s1, ::s1]
    return out.to(data1.dtype)


# -- DeformablePSROIPooling ---------------------------------------------------

@register("_contrib_DeformablePSROIPooling", num_inputs=None,
          aliases=("DeformablePSROIPooling",))
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=1,
                              part_size=0, sample_per_part=1, trans_std=0.0,
                              no_trans=False):
    """Position-sensitive ROI pooling with learned part offsets: data has
    ``output_dim * group_size^2`` channels; each pooled cell averages
    ``sample_per_part^2`` bilinear samples of its channel group, moved by
    ``trans`` (R, 2, part, part) scaled by ``trans_std`` and the ROI's
    size.  Returns (R, output_dim, pooled, pooled)."""
    ps, gs, spp = int(pooled_size), int(group_size), int(sample_per_part)
    od = int(output_dim)
    part = int(part_size) or ps
    r = rois.shape[0]
    dataf = data.float()
    roisf = rois.float()
    x1 = roisf[:, 1] * spatial_scale - 0.5
    y1 = roisf[:, 2] * spatial_scale - 0.5
    x2 = (roisf[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = (roisf[:, 4] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bin_w, bin_h = rw / ps, rh / ps
    per_roi = dataf[roisf[:, 0].long()]
    zero = torch.zeros((r,), dtype=torch.float32, device=data.device)
    rows = torch.arange(r, device=data.device)
    outs = []
    for py in range(ps):
        for px in range(ps):
            ty = tx = zero
            if not no_trans and trans is not None:
                tpy, tpx = min(py * part // ps, part - 1), \
                    min(px * part // ps, part - 1)
                tf = trans.float()
                sel = rows % tf.shape[0]
                ty = tf[sel, 0, tpy, tpx] * trans_std * rh
                tx = tf[sel, 1, tpy, tpx] * trans_std * rw
            acc = 0.0
            for sy in range(spp):
                for sx in range(spp):
                    ys = (y1 + py * bin_h + (sy + 0.5) * bin_h / spp
                          + ty)[:, None, None]
                    xs = (x1 + px * bin_w + (sx + 0.5) * bin_w / spp
                          + tx)[:, None, None]
                    acc = acc + _bilinear_gather(per_roi, xs, ys)
            acc = acc / (spp * spp)
            g = min(py * gs // ps, gs - 1) * gs + min(px * gs // ps, gs - 1)
            outs.append(acc[:, g * od:(g + 1) * od, 0, 0])
    return torch.stack(outs, dim=-1).reshape(r, od, ps, ps).to(data.dtype)


# -- Proposal / MultiProposal -----------------------------------------------

def _make_anchors(feat_h, feat_w, stride, scales, ratios, dev):
    """The RPN's anchors, (H * W * A, 4) corners, A = ratios x scales
    around each stride-spaced position (the reference's ``_make_anchors``,
    a copy: the port imports nothing of it)."""
    base = float(stride)
    px = py = (base - 1) / 2.0
    anchors = []
    for ratio in ratios:
        ws = round(math.sqrt(base * base / ratio))
        hs = round(ws * ratio)
        for scale in scales:
            w_s, h_s = ws * scale, hs * scale
            anchors.append([px - (w_s - 1) / 2, py - (h_s - 1) / 2,
                            px + (w_s - 1) / 2, py + (h_s - 1) / 2])
    a = torch.tensor(anchors, dtype=torch.float32, device=dev)
    sx = torch.arange(feat_w, dtype=torch.float32, device=dev) * stride
    sy = torch.arange(feat_h, dtype=torch.float32, device=dev) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx.reshape(-1), gy.reshape(-1), gx.reshape(-1),
                          gy.reshape(-1)], dim=1)
    return (shifts[:, None, :] + a[None]).reshape(-1, 4)


def _fma(a, b, c):
    """``a * b + c`` of float32 tensors with one rounding: the product is
    exact in float64, so is the sum but for a tie to float32 (2^-29 of
    the cases)."""
    return (a.double() * b.double() + c.double()).float()


def _proposal_one(scores, deltas, im_info, anchors, pre_n, post_n,
                  nms_thresh, min_size, iou_loss):
    """One image: scores (K,), deltas (K, 4), anchors (K, 4) -> boxes
    (post_n, 4) and scores (post_n,) in float32."""
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1)
    if iou_loss:
        x1, y1 = anchors[:, 0] + deltas[:, 0], anchors[:, 1] + deltas[:, 1]
        x2, y2 = anchors[:, 2] + deltas[:, 2], anchors[:, 3] + deltas[:, 3]
    else:
        # ``d * w + c`` rounded once, as the reference's compiled program
        # fuses it; and exp in float64 rounded once: the card's and the
        # CPU's float32 exp may differ in the last bit, and a box must not
        # move between them
        px = _fma(deltas[:, 0], widths, ctr_x)
        py = _fma(deltas[:, 1], heights, ctr_y)
        pw = torch.exp(torch.clamp(deltas[:, 2], -10, 10).double()).float() \
            * widths
        ph = torch.exp(torch.clamp(deltas[:, 3], -10, 10).double()).float() \
            * heights
        x1, y1 = px - 0.5 * (pw - 1), py - 0.5 * (ph - 1)
        x2, y2 = px + 0.5 * (pw - 1), py + 0.5 * (ph - 1)
    imh, imw = im_info[0], im_info[1]
    x1 = torch.minimum(torch.clamp_min(x1, 0), imw - 1.0)
    y1 = torch.minimum(torch.clamp_min(y1, 0), imh - 1.0)
    x2 = torch.minimum(torch.clamp_min(x2, 0), imw - 1.0)
    y2 = torch.minimum(torch.clamp_min(y2, 0), imh - 1.0)
    ms = min_size * im_info[2]
    keep = ((x2 - x1 + 1) >= ms) & ((y2 - y1 + 1) >= ms)
    scores = torch.where(keep, scores, torch.full_like(scores, -1.0))
    pre_n = min(pre_n, scores.shape[0])
    # descending and stable: among equal scores the lower index first, as
    # lax.top_k
    top_scores, order = torch.sort(scores, descending=True, stable=True)
    top_scores, order = top_scores[:pre_n], order[:pre_n]
    boxes = torch.stack([x1, y1, x2, y2], dim=1)[order]
    area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    xx1 = torch.maximum(boxes[:, None, 0], boxes[None, :, 0])
    yy1 = torch.maximum(boxes[:, None, 1], boxes[None, :, 1])
    xx2 = torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
    yy2 = torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = torch.clamp_min(xx2 - xx1 + 1, 0) * torch.clamp_min(
        yy2 - yy1 + 1, 0)
    iou = inter / (area[:, None] + area[None, :] - inter)
    # row j of ``kill``: the candidates that picking j removes (itself too)
    kill = (iou > nms_thresh).to(torch.uint8)
    del xx1, yy1, xx2, yy2, inter, iou
    kill.fill_diagonal_(1)
    alive = (top_scores > -1.0).to(torch.uint8)
    picks = torch.zeros(post_n, dtype=torch.int64, device=scores.device)
    oks = torch.zeros(post_n, dtype=torch.bool, device=scores.device)
    for c in range(post_n):
        # the first alive candidate (the highest score); none alive: 0
        j = torch.argmax(alive)
        ok = alive[j].bool()
        picks[c] = j
        oks[c] = ok
        alive = alive * (1 - kill[j] * ok)
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    pboxes = torch.where(oks[:, None], boxes[picks], zero)
    pscores = torch.where(oks, top_scores[picks], zero)
    # the empty slots hold the first proposal
    return (torch.where(oks[:, None], pboxes, pboxes[0]),
            torch.where(oks, pscores, pscores[0]))


@register("_contrib_Proposal", num_inputs=3, differentiable=False,
          aliases=("Proposal",))
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
              output_score=False, iou_loss=False):
    """The RPN's proposal layer: anchors moved by ``bbox_pred``, clipped to
    the image, boxes under ``rpn_min_size`` (times the image's scale)
    scored -1, the best ``rpn_pre_nms_top_n`` by foreground score through
    greedy NMS at IoU ``threshold``, ``rpn_post_nms_top_n`` kept an image:
    (batch index, x1, y1, x2, y2) rows, and their scores with
    ``output_score``."""
    n, two_a, fh, fw = cls_prob.shape
    a = two_a // 2
    post_n = int(rpn_post_nms_top_n)
    if cls_prob.device.type == "meta":
        rois = torch.empty((n * post_n, 5), device="meta")
        return (rois, torch.empty((n * post_n, 1), device="meta")) \
            if output_score else rois
    anchors = _make_anchors(fh, fw, int(feature_stride),
                            [float(s) for s in scales],
                            [float(r) for r in ratios], cls_prob.device)
    rois, scores_out = [], []
    for b in range(n):
        scores = cls_prob[b, a:].float().permute(1, 2, 0).reshape(-1)
        deltas = bbox_pred[b].float().reshape(a, 4, fh, fw).permute(
            2, 3, 0, 1).reshape(-1, 4)
        boxes, sc = _proposal_one(
            scores, deltas, im_info[b].float(), anchors,
            int(rpn_pre_nms_top_n), post_n, float(threshold),
            float(rpn_min_size), bool(iou_loss))
        rois.append(torch.cat([torch.full((post_n, 1), float(b),
                                          device=boxes.device), boxes], 1))
        scores_out.append(sc[:, None])
    rois = torch.cat(rois, dim=0)
    if output_score:
        return rois, torch.cat(scores_out, dim=0)
    return rois


OPS["_contrib_MultiProposal"] = OPS["_contrib_Proposal"]
OPS["MultiProposal"] = OPS["_contrib_Proposal"]


# -- SyncBatchNorm -------------------------------------------------------------

@register("_contrib_SyncBatchNorm", aliases=("SyncBatchNorm",),
          aux_update=_batch_norm_aux_update, mutate_idx=(3, 4))
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key=None, axis=1):
    """``BatchNorm``'s body: under ``TrainStep``'s data-parallel scope it
    takes its statistics over the dp ranks already; ``ndev`` and ``key``
    are accepted and unused, as in the reference."""
    return _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=eps,
                          momentum=momentum, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats,
                          output_mean_var=output_mean_var, axis=axis)


# -- the transformer's fused matmuls ---------------------------------------------

def _sqrt_dim(x):
    """sqrt(the last dimension) as a tensor of ``x``'s type: a division by
    it is a division on the card too, not a product by its reciprocal."""
    return torch.sqrt(torch.tensor(float(x.shape[-1]), dtype=torch.float32,
                                   device=x.device)).to(x.dtype)


@register("_contrib_div_sqrt_dim", num_inputs=1)
def _div_sqrt_dim(data):
    return data / _sqrt_dim(data)


def _split_heads(x, heads, n_parts):
    """(S, B, heads * hd * n_parts) -> n_parts tensors (B * heads, S, hd);
    the projections interleave per head (q, k, v of head 0, then of head
    1, ...), as GluonNLP lays them out."""
    s, b, proj = x.shape
    hd = proj // (heads * n_parts)
    tmp = x.reshape(s, b, heads, n_parts, hd)
    return [tmp[:, :, :, i, :].permute(1, 2, 0, 3).reshape(b * heads, s, hd)
            for i in range(n_parts)]


def _merge_heads(out, b, heads):
    """(B * heads, S, hd) -> (S, B, heads * hd)."""
    _, s, hd = out.shape
    return out.reshape(b, heads, s, hd).permute(2, 0, 1, 3).reshape(
        s, b, heads * hd)


@register("_contrib_interleaved_matmul_selfatt_qk", num_inputs=1)
def _interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """(S, B, H * hd * 3) -> the scaled scores Q K^T (B * H, S, S)."""
    q, k, _ = _split_heads(queries_keys_values, int(heads), 3)
    return torch.bmm(q / _sqrt_dim(q), k.transpose(1, 2))


@register("_contrib_interleaved_matmul_selfatt_valatt", num_inputs=2)
def _interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                       heads=1):
    """attention (B * H, S, S) times V -> (S, B, H * hd)."""
    h = int(heads)
    _, _, v = _split_heads(queries_keys_values, h, 3)
    return _merge_heads(torch.bmm(attention, v),
                        queries_keys_values.shape[1], h)


@register("_contrib_interleaved_matmul_encdec_qk", num_inputs=2)
def _interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """queries (Sq, B, H * hd), keys_values (Sk, B, H * hd * 2) -> the
    scaled scores (B * H, Sq, Sk)."""
    h = int(heads)
    (q,) = _split_heads(queries, h, 1)
    k, _ = _split_heads(keys_values, h, 2)
    return torch.bmm(q / _sqrt_dim(q), k.transpose(1, 2))


@register("_contrib_interleaved_matmul_encdec_valatt", num_inputs=2)
def _interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """attention (B * H, Sq, Sk) times V -> (Sq, B, H * hd)."""
    h = int(heads)
    _, v = _split_heads(keys_values, h, 2)
    return _merge_heads(torch.bmm(attention, v), keys_values.shape[1], h)


# -- fft / ifft / count_sketch ------------------------------------------------------

@register("_contrib_fft", num_inputs=1)
def _fft(data, compute_size=128):
    """The FFT over the last axis, (..., d) -> (..., 2d) float32 with the
    real and imaginary parts interleaved."""
    spec = torch.fft.fft(data.float(), dim=-1)
    return torch.stack([spec.real, spec.imag], dim=-1).reshape(
        tuple(data.shape[:-1]) + (2 * data.shape[-1],))


@register("_contrib_ifft", num_inputs=1)
def _ifft(data, compute_size=128):
    """The inverse of ``_contrib_fft``'s layout, unnormalised as cuFFT's:
    ``ifft(fft(x)) == x * d``; float32."""
    d = data.shape[-1] // 2
    pairs = data.float().reshape(tuple(data.shape[:-1]) + (d, 2))
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(spec, dim=-1).real * d


@register("_contrib_count_sketch", num_inputs=3, differentiable=False)
def _count_sketch(data, h, s, out_dim=1, processing_batch_size=32):
    """The count sketch: ``out[:, h[j]] += s[j] * data[:, j]``."""
    n, d = data.shape
    hv = torch.broadcast_to(h.long().reshape(-1, d), (n, d))
    sv = torch.broadcast_to(s.to(data.dtype).reshape(-1, d), (n, d))
    rows = torch.broadcast_to(torch.arange(n, device=data.device)[:, None],
                              (n, d))
    out = torch.zeros((n, int(out_dim)), dtype=data.dtype, device=data.device)
    return out.index_put((rows, hv), data * sv, accumulate=True)


# -- boolean_mask / index_copy / index_array ------------------------------------

@register("_contrib_boolean_mask", num_inputs=2, aliases=("boolean_mask",),
          no_trace=True)
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is not 0; the
    output's shape follows the data, so it runs on arrays only."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, int(axis), keep)


@register("_contrib_index_copy", num_inputs=3)
def _index_copy(old, index, new):
    """``old`` with the rows ``index`` replaced by ``new``'s, as a new
    array; differentiable in both."""
    return torch.index_copy(old, 0, index.long(), new.to(old.dtype))


@register("_contrib_index_array", num_inputs=1, differentiable=False)
def _index_array(data, axes=None):
    """Each element's index along ``axes`` (all by default): int64 of
    shape ``data.shape + (len(axes),)``."""
    axes = range(data.dim()) if axes is None else [int(a) for a in axes]
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int64,
                                          device=data.device)
                             for s in data.shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1)
