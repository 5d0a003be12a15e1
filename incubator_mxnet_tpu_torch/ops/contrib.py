"""Detection and bounding-box contrib ops (port of
``incubator_mxnet_tpu/ops/contrib.py``): ``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``, ``box_iou``, ``box_nms``,
``bipartite_matching``, ``ROIPooling`` and ``ROIAlign``, registered under
the reference's names, aliases and flags.

Each op is batched over its images in torch ops on the inputs' device;
none reaches a hand-written kernel (the reference computes them as
static-shape XLA formulations, no Pallas).  The greedy loops run in
eager PyTorch without a host sync inside them:

- NMS (``MultiBoxDetection``, ``box_nms``) reads one number back, the
  largest count of rows that can be kept in the batch (``nkeep``): rows
  at or beyond an image's ``nkeep`` never suppress and are never kept,
  so only that prefix enters.  Its pairwise IoU and suppression mask
  are computed once, in blocks of rows, and the greedy pass is two
  launches a row.
- The bipartite stages (``MultiBoxTarget``, ``bipartite_matching``)
  loop over ``min(rows, columns)`` with the batch's argmax and masked
  row and column updates in place.

The reference runs with ``jax_enable_x64``: ``bipartite_matching``
returns float64, ``MultiBoxTarget`` compares the matched IoU with
``negative_mining_thresh`` in float64 and counts its negatives from a
float64 product.  Its hard-negative ranking here is by the background
probability in float64 (the reference ranks its float32 softmax), so
that the card and the CPU rank alike; the two orders differ only where
two anchors' float32 probabilities tie or lie within a float32 rounding
of each other.  Descending sorts are stable ascending sorts of the
negated key, as in the reference (``torch.sort`` and ``jnp.argsort``
both treat -0.0 and 0.0 as equal and put NaN last).

A division by a Python number on the card is a multiplication by its
reciprocal in PyTorch, one rounding away from the reference's division;
where a quotient decides a bin edge or a target, it divides by a
tensor (``_div``).  On ``meta`` tensors (``Op.infer``) the ops whose
bodies need values answer from the shapes and dtypes.
"""
from __future__ import annotations

import ast
import math

import torch

from .registry import register

__all__ = []

#: the most elements of a block of the NMS suppression mask (256 MB f32)
_NMS_BLOCK_ELEMS = 1 << 26


def _tuple(v, n=None, typ=float):
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if not isinstance(v, (tuple, list)):
        v = (v,) * (n or 1)
    return tuple(typ(x) for x in v)


def _is_meta(*tensors):
    return any(t.device.type == "meta" for t in tensors)


def _div(x, s):
    """``x / s`` by true division on every device (see the module
    docstring)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# IoU helpers
# ---------------------------------------------------------------------------

def _corner_iou(lhs, rhs):
    """IoU between corner boxes lhs (..., 4) and rhs (..., 4), broadcast
    over leading dims: the reference's f32 operations in its order."""
    il = torch.maximum(lhs[..., 0], rhs[..., 0])
    it = torch.maximum(lhs[..., 1], rhs[..., 1])
    ir = torch.minimum(lhs[..., 2], rhs[..., 2])
    ib = torch.minimum(lhs[..., 3], rhs[..., 3])
    iw = (ir - il).clamp_min(0)
    ih = (ib - it).clamp_min(0)
    inter = iw * ih
    area_l = (lhs[..., 2] - lhs[..., 0]).clamp_min(0) * \
        (lhs[..., 3] - lhs[..., 1]).clamp_min(0)
    area_r = (rhs[..., 2] - rhs[..., 0]).clamp_min(0) * \
        (rhs[..., 3] - rhs[..., 1]).clamp_min(0)
    union = area_l + area_r - inter
    # double where: the zero-union branch stays out of the gradient
    pos = union > 0
    safe_union = torch.where(pos, union, 1.0)
    return torch.where(pos, inter / safe_union, 0.0)


def _to_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    x, y, w, h = (boxes[..., i] for i in range(4))
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _from_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    l, t, r, b = (boxes[..., i] for i in range(4))
    return torch.stack([(l + r) / 2, (t + b) / 2, r - l, b - t], dim=-1)


def _greedy_keep(boxes, alive, ids, thresh, k):
    """Greedy suppression over score-sorted rows (n, A): row j dies if an
    earlier surviving row i (of the same id unless ``ids`` is None) has
    IoU >= ``thresh`` with it.  ``alive`` marks the rows that may be
    kept; none lies at or beyond column ``k``.  Returns the kept mask."""
    keep = alive.clone()
    if k == 0:
        return keep
    n = alive.shape[0]
    head = boxes[:, :k]
    keepf = alive[:, :k].to(boxes.dtype)
    ones = torch.ones_like(keepf)
    factor = torch.empty_like(keepf)
    col = torch.arange(k, device=boxes.device)
    block = max(1, min(k, _NMS_BLOCK_ELEMS // max(1, n * k)))
    for r0 in range(0, k, block):
        r1 = min(k, r0 + block)
        iou = _corner_iou(head[:, r0:r1, None, :], head[:, None, :, :])
        sup = (iou >= thresh) & (col[None, None, :] > col[r0:r1, None])
        if ids is not None:
            sup &= ids[:, r0:r1, None] == ids[:, None, :k]
        sup = sup.to(boxes.dtype)
        for i in range(r0, r1):
            # keep_j *= 1 - keep_i * sup_ij: a dead row i suppresses nothing
            torch.addcmul(ones, keepf[:, i:i + 1], sup[:, i - r0], value=-1,
                          out=factor)
            keepf.mul_(factor)
    keep[:, :k] = keepf > 0
    return keep


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", num_inputs=1, differentiable=False,
          aliases=("MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes per feature-map pixel (multibox_prior.cc:40-70):
    num_sizes + num_ratios - 1 anchors, corner format, normalized coords,
    (1, H*W*k, 4) f32."""
    sizes = _tuple(sizes)
    ratios = _tuple(ratios)
    steps = _tuple(steps, 2)
    offsets = _tuple(offsets, 2)
    in_h, in_w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    cy = (torch.arange(in_h, dtype=torch.float32, device=dev)
          + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=torch.float32, device=dev)
          + offsets[1]) * step_x

    ws, hs = [], []
    r0 = math.sqrt(ratios[0])
    for s in sizes:
        ws.append(s * in_h / in_w * r0 / 2)
        hs.append(s / r0 / 2)
    for r in ratios[1:]:
        rr = math.sqrt(r)
        ws.append(sizes[0] * in_h / in_w * rr / 2)
        hs.append(sizes[0] / rr / 2)
    k = len(ws)
    ws = torch.tensor(ws, dtype=torch.float32, device=dev)
    hs = torch.tensor(hs, dtype=torch.float32, device=dev)

    cxg = cx[None, :, None].expand(in_h, in_w, k)
    cyg = cy[:, None, None].expand(in_h, in_w, k)
    out = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], dim=-1)
    out = out.reshape(1, in_h * in_w * k, 4)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------

def _encode_loc(anchors, gt, variances):
    """(gx-ax)/aw/vx, (gy-ay)/ah/vy, log(gw/aw)/vw, log(gh/ah)/vh
    (multibox_target.cc:32-54 AssignLocTargets)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    aw, ah = aw.clamp_min(1e-12), ah.clamp_min(1e-12)
    return torch.stack([
        _div((gx - ax) / aw, variances[0]),
        _div((gy - ay) / ah, variances[1]),
        _div(torch.log(gw.clamp_min(1e-12) / aw), variances[2]),
        _div(torch.log(gh.clamp_min(1e-12) / ah), variances[3])], dim=-1)


def _bipartite_stage(overlaps):
    """Greedy bipartite matching over (n, A, L) IoUs, in place on a copy
    (multibox_target.cc:112-148): each step takes an image's largest
    unmasked IoU (first in row-major order) and, when it is above 1e-6,
    matches its anchor and label and masks both.  Returns the matched
    label per anchor (-1 where none) and its IoU."""
    n, num_anchors, num_labels = overlaps.shape
    masked = overlaps.clone(memory_format=torch.contiguous_format)
    flat = masked.view(n, -1)
    rows = torch.arange(n, device=overlaps.device)
    m_gt = torch.full((n, num_anchors), -1, dtype=torch.int64,
                      device=overlaps.device)
    m_iou = torch.full((n, num_anchors), -1.0, dtype=overlaps.dtype,
                       device=overlaps.device)
    for _ in range(num_labels):
        pick = flat.argmax(1)
        bi = torch.div(pick, num_labels, rounding_mode="floor")
        bj = pick - bi * num_labels
        val = flat.gather(1, pick[:, None])[:, 0]
        ok = val > 1e-6
        m_iou[rows, bi] = torch.where(ok, val, m_iou[rows, bi])
        m_gt[rows, bi] = torch.where(ok, bj, m_gt[rows, bi])
        okc = ok[:, None]
        masked[rows, bi, :] = torch.where(okc, -1.0, masked[rows, bi, :])
        masked[rows, :, bj] = torch.where(okc, -1.0, masked[rows, :, bj])
    return m_gt, m_iou


@register("_contrib_MultiBoxTarget", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=("MultiBoxTarget",))
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets -> (loc_target (N, A*4), loc_mask (N, A*4),
    cls_target (N, A)) (multibox_target.cc:80-280)."""
    variances = _tuple(variances, 4)
    overlap_threshold = float(overlap_threshold)
    ignore_label = float(ignore_label)
    negative_mining_ratio = float(negative_mining_ratio)
    anchors = anchor.reshape(-1, 4)
    n = label.shape[0]
    num_anchors = anchors.shape[0]
    loc_dtype = torch.promote_types(anchors.dtype, label.dtype)
    if _is_meta(anchor, label, cls_pred):
        loc = torch.empty((n, num_anchors * 4), dtype=loc_dtype,
                          device="meta")
        return loc, torch.empty_like(loc), torch.empty(
            (n, num_anchors), dtype=anchors.dtype, device="meta")
    dev = anchors.device
    gt_valid = label[:, :, 0] != -1.0                           # (n, L)
    has_gt = gt_valid.any(1)                                    # (n,)
    overlaps = _corner_iou(anchors[None, :, None, :],
                           label[:, None, :, 1:5])              # (n, A, L)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)

    # stage 1: greedy bipartite matching; stage 2: per-anchor threshold
    bip_gt, bip_iou = _bipartite_stage(overlaps)
    a_matched = bip_gt >= 0
    best_iou = overlaps.amax(2)
    best_gt = overlaps.argmax(2)
    thr_pos = (~a_matched) & (best_iou > overlap_threshold) \
        & has_gt[:, None] if overlap_threshold > 0 else \
        torch.zeros_like(a_matched)
    m_gt = torch.where(a_matched, bip_gt, best_gt)
    positive = a_matched | thr_pos

    # stage 3: negatives (:181-248); the reference holds m_iou in f64
    if negative_mining_ratio > 0:
        m_iou = torch.where(a_matched, bip_iou, best_iou).double()
        num_pos = positive.sum(1)
        num_neg = torch.minimum(
            (num_pos.double() * negative_mining_ratio).long(),
            num_anchors - num_pos).clamp_min(int(minimum_negative_samples))
        eligible = (~positive) & (m_iou < float(negative_mining_thresh))
        # hardest negatives: lowest background probability first
        bg_prob = torch.softmax(cls_pred.double(), dim=1)[:, 0]  # (n, A)
        key = torch.where(eligible, bg_prob, math.inf)
        order = torch.sort(key, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(num_anchors, device=dev).expand(
                n, num_anchors))
        negative = eligible & (rank < num_neg[:, None])
    else:
        negative = ~positive

    # targets (:250-277); an image without a valid label keeps the
    # initial outputs (:106)
    idx = m_gt.clamp_min(0)
    cls_of_match = label[:, :, 0].gather(1, idx) + 1.0
    cls_target = torch.where(positive, cls_of_match,
                             torch.where(negative, 0.0, ignore_label))
    gt_box = label[:, :, 1:5].gather(1, idx[..., None].expand(-1, -1, 4))
    loc = _encode_loc(anchors[None], gt_box, variances)         # (n, A, 4)
    pos = (positive & has_gt[:, None])[..., None]
    loc_target = torch.where(pos, loc, 0.0)
    loc_mask = pos.to(loc_dtype).expand(-1, -1, 4)
    cls_target = torch.where(has_gt[:, None], cls_target, ignore_label)
    return (loc_target.reshape(n, -1), loc_mask.reshape(n, -1),
            cls_target.to(anchors.dtype))


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------

def _decode_loc(anchors, pred, variances, clip):
    """Inverse of _encode_loc (multibox_detection.cc:46-80
    TransformLocations)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    ox = pred[..., 0] * variances[0] * aw + ax
    oy = pred[..., 1] * variances[1] * ah + ay
    ow = torch.exp(pred[..., 2] * variances[2]) * aw / 2
    oh = torch.exp(pred[..., 3] * variances[3]) * ah / 2
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out


def _sorted_desc(key):
    """Indices that sort ``key`` (n, A) descending, ties in index order:
    the reference's ``argsort(-key, stable=True)``."""
    return torch.sort(-key, dim=1, stable=True).indices


@register("_contrib_MultiBoxDetection", num_inputs=3, differentiable=False,
          aliases=("MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode + NMS -> (N, A, 6) rows [cls_id, score, xmin, ymin, xmax,
    ymax], sorted by score; suppressed rows are -1
    (multibox_detection.cc:85)."""
    variances = _tuple(variances, 4)
    nms_threshold = float(nms_threshold)
    nms_topk = int(nms_topk)
    background_id = int(background_id)
    anchors = anchor.reshape(-1, 4)
    n, num_classes, num_anchors = cls_prob.shape
    out_dtype = torch.promote_types(
        torch.promote_types(cls_prob.dtype, torch.float32),
        torch.promote_types(anchors.dtype, loc_pred.dtype))
    if _is_meta(cls_prob, loc_pred, anchor):
        return torch.empty((n, num_anchors, 6), dtype=out_dtype,
                           device="meta")
    dev = cls_prob.device
    # foreground: every class row but background_id, numbered 0.. in order
    cls_idx = [j for j in range(num_classes) if j != background_id]
    fg = cls_prob[:, cls_idx, :]
    score = fg.amax(1)
    best = fg.argmax(1)
    row_id = torch.where(score < float(threshold), -1.0, best.float())
    boxes = _decode_loc(anchors[None], loc_pred.reshape(n, -1, 4),
                        variances, bool(clip))

    key = torch.where(row_id >= 0, score, -math.inf)
    order = _sorted_desc(key)
    row_id = row_id.gather(1, order)
    score = score.gather(1, order)
    boxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    nkeep = (row_id >= 0).sum(1)
    if nms_topk > 0:
        nkeep = nkeep.clamp_max(nms_topk)
    # valid rows beyond the top k are dropped (:162-168)
    alive = torch.arange(num_anchors, device=dev)[None, :] < nkeep[:, None]
    row_id = torch.where(alive, row_id, -1.0)
    if 0 < nms_threshold <= 1:
        keep = _greedy_keep(boxes, row_id >= 0,
                            None if force_suppress else row_id,
                            nms_threshold, int(nkeep.max()))
        row_id = torch.where(keep, row_id, -1.0)
    out = torch.cat([row_id[..., None].to(out_dtype),
                     score[..., None].to(out_dtype), boxes.to(out_dtype)],
                    dim=2)
    return torch.where(row_id[..., None] >= 0, out, -1.0)


# ---------------------------------------------------------------------------
# bounding_box.cc ops
# ---------------------------------------------------------------------------

@register("_contrib_box_iou", num_inputs=2, aliases=("box_iou",))
def _box_iou(lhs, rhs, format="corner"):  # noqa: A002
    """Pairwise IoU: out shape lhs.shape[:-1] + rhs.shape[:-1]
    (bounding_box.cc:121)."""
    lhs = _to_corner(lhs, format)
    rhs = _to_corner(rhs, format)
    ls = lhs.shape[:-1]
    rs = rhs.shape[:-1]
    out = _corner_iou(lhs.reshape(-1, 1, 4), rhs.reshape(1, -1, 4))
    return out.reshape(ls + rs)


@register("_contrib_box_nms", num_inputs=1, differentiable=False,
          aliases=("box_nms",))
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """NMS over (..., num_box, k) rows; surviving rows sorted by score
    descending, suppressed rows all -1 (bounding_box.cc:40)."""
    if _is_meta(data):
        return torch.empty_like(data)
    shape = data.shape
    num_box, width = shape[-2], shape[-1]
    cs = int(coord_start)
    id_index = int(id_index)
    flat = data.reshape(-1, num_box, width)
    score = flat[..., int(score_index)]
    valid = score > float(valid_thresh)
    if id_index >= 0:
        ids = flat[..., id_index]
        if background_id >= 0:
            valid &= ids != background_id
    order = _sorted_desc(torch.where(valid, score, -math.inf))
    rows_s = flat.gather(1, order[..., None].expand(-1, -1, width))
    valid_s = valid.gather(1, order)
    nkeep = valid_s.sum(1)
    if topk > 0:
        nkeep = nkeep.clamp_max(int(topk))
    boxes = _to_corner(rows_s[..., cs:cs + 4], in_format)
    alive = valid_s & (torch.arange(num_box, device=data.device)[None, :]
                       < nkeep[:, None])
    ids_s = None
    if id_index >= 0:
        ids_s = ids.gather(1, order)
        alive &= ids_s > -math.inf  # the reference's marker is the id
    keep = _greedy_keep(boxes, alive,
                        None if force_suppress or id_index < 0 else ids_s,
                        float(overlap_thresh), int(nkeep.max()))
    out_rows = rows_s
    if out_format != in_format:
        out_rows = rows_s.clone()
        out_rows[..., cs:cs + 4] = _from_corner(boxes, out_format)
    return torch.where(keep[..., None], out_rows, -1.0).reshape(shape)


@register("_contrib_bipartite_matching", num_inputs=1, num_outputs=2,
          differentiable=False, aliases=("bipartite_matching",))
def _bipartite_matching(dist, is_ascend=False, threshold=None):
    """Greedy bipartite matching over (..., M, N) scores -> (row_match,
    col_match), float64 indices, -1 unmatched (bounding_box.cc:162)."""
    shape = dist.shape
    m, n = shape[-2], shape[-1]
    if _is_meta(dist):
        return (torch.empty(shape[:-1], dtype=torch.float64, device="meta"),
                torch.empty(shape[:-2] + (n,), dtype=torch.float64,
                            device="meta"))
    flat = dist.reshape(-1, m, n)
    b = flat.shape[0]
    dev = dist.device
    masked = (flat * (1.0 if is_ascend else -1.0)).contiguous()
    mflat = masked.view(b, -1)
    dflat = flat.reshape(b, -1)
    rows = torch.arange(b, device=dev)
    rmatch = torch.full((b, m), -1.0, dtype=torch.float64, device=dev)
    cmatch = torch.full((b, n), -1.0, dtype=torch.float64, device=dev)
    for _ in range(min(m, n)):
        pick = mflat.argmin(1)
        bi = torch.div(pick, n, rounding_mode="floor")
        bj = pick - bi * n
        ok = torch.isfinite(mflat.gather(1, pick[:, None])[:, 0])
        if threshold is not None:
            val = dflat.gather(1, pick[:, None])[:, 0]
            ok &= (val <= threshold) if is_ascend else (val >= threshold)
        rmatch[rows, bi] = torch.where(ok, bj.double(), rmatch[rows, bi])
        cmatch[rows, bj] = torch.where(ok, bi.double(), cmatch[rows, bj])
        okc = ok[:, None]
        masked[rows, bi, :] = torch.where(okc, math.inf, masked[rows, bi, :])
        masked[rows, :, bj] = torch.where(okc, math.inf, masked[rows, :, bj])
    return rmatch.reshape(shape[:-1]), cmatch.reshape(shape[:-2] + (n,))


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------

@register("ROIPooling", num_inputs=2)
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max pooling over quantized ROI bins (src/operator/roi_pooling.cc).
    data (N, C, H, W); rois (R, 5) rows [batch_idx, x1, y1, x2, y2].  The
    reference's form: a (C, ph, pw, H, W) mask a ROI, so ties share the
    gradient as ``jnp.max``'s do (``amax``)."""
    ph, pw = _tuple(pooled_size, 2, int)
    n, c, h, w = data.shape
    if _is_meta(data, rois):
        return data.new_empty((rois.shape[0], c, ph, pw))
    scale = float(spatial_scale)
    dev = data.device
    rois = rois.float()
    img = data[rois[:, 0].long()]                           # (R, C, H, W)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in range(1, 5))
    bin_h = _div((y2 - y1 + 1).clamp_min(1.0), ph)[:, None]
    bin_w = _div((x2 - x1 + 1).clamp_min(1.0), pw)[:, None]
    i = torch.arange(ph, dtype=torch.float32, device=dev)
    j = torch.arange(pw, dtype=torch.float32, device=dev)
    hstart = (torch.floor(i * bin_h) + y1[:, None]).clamp(0, h)
    hend = (torch.ceil((i + 1) * bin_h) + y1[:, None]).clamp(0, h)
    wstart = (torch.floor(j * bin_w) + x1[:, None]).clamp(0, w)
    wend = (torch.ceil((j + 1) * bin_w) + x1[:, None]).clamp(0, w)
    rr = torch.arange(h, dtype=torch.float32, device=dev)
    cc = torch.arange(w, dtype=torch.float32, device=dev)
    mrow = (rr >= hstart[..., None]) & (rr < hend[..., None])  # (R, ph, H)
    mcol = (cc >= wstart[..., None]) & (cc < wend[..., None])  # (R, pw, W)
    mask = mrow[:, :, None, :, None] & mcol[:, None, :, None, :]
    vals = torch.where(mask[:, None], img[:, :, None, None], -math.inf)
    pooled = vals.amax(dim=(-2, -1))                        # (R, C, ph, pw)
    return torch.where(torch.isfinite(pooled), pooled, 0.0).to(data.dtype)


@register("_contrib_ROIAlign", num_inputs=2, aliases=("ROIAlign",))
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False):
    """Bilinear ROI align (src/operator/contrib/roi_align.cc), with the
    reference's fixed 2x2 sample grid a bin when ``sample_ratio`` <= 0
    (the upstream op picks ceil(roi/bin) from the data)."""
    ph, pw = _tuple(pooled_size, 2, int)
    n, c, h, w = data.shape
    num_rois = rois.shape[0]
    if _is_meta(data, rois):
        return data.new_empty((num_rois, c, ph, pw))
    scale = float(spatial_scale)
    sr = int(sample_ratio) if int(sample_ratio) > 0 else 2
    off = 0.5 if aligned else 0.0
    dev = data.device
    rois = rois.float()
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * scale - off for i in range(1, 5))
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp_min(1.0), roi_h.clamp_min(1.0)
    bin_h = _div(roi_h, ph)
    bin_w = _div(roi_w, pw)
    # sample offsets inside a bin: (k + 0.5) / sr
    offs = _div(torch.arange(sr, dtype=torch.float32, device=dev) + 0.5, sr)
    gy = y1[:, None, None] + (torch.arange(
        ph, dtype=torch.float32, device=dev)[:, None] + offs) \
        * bin_h[:, None, None]                              # (R, ph, sr)
    gx = x1[:, None, None] + (torch.arange(
        pw, dtype=torch.float32, device=dev)[:, None] + offs) \
        * bin_w[:, None, None]                              # (R, pw, sr)
    y = gy.reshape(num_rois, -1, 1).clamp(0.0, h - 1.0)    # (R, P, 1)
    x = gx.reshape(num_rois, 1, -1).clamp(0.0, w - 1.0)    # (R, 1, Q)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1i = (y0 + 1).clamp_max(h - 1)
    x1i = (x0 + 1).clamp_max(w - 1)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]
    bb = b[:, None, None]
    # data[b, :, y, x] with the indices broadcast to (R, P, Q): (R, P, Q, C)
    v00 = data[bb, :, y0, x0]
    v01 = data[bb, :, y0, x1i]
    v10 = data[bb, :, y1i, x0]
    v11 = data[bb, :, y1i, x1i]
    samp = (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx +
            v10 * ly * (1 - lx) + v11 * ly * lx)
    samp = samp.reshape(num_rois, ph, sr, pw, sr, c)
    out = _div(samp.sum(dim=(2, 4)), sr * sr)               # (R, ph, pw, C)
    return out.permute(0, 3, 1, 2).to(data.dtype)
