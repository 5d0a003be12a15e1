"""Fused ghost batch norm (+residual add, +ReLU) on the H100.

Port of ``incubator_mxnet_tpu/parallel/fused_bn.py``.  Statistics are
taken per *ghost group* of images, per channel, in f32; the forward
normalizes, adds the residual and rectifies in one kernel (K1,
``csrc/ghost_bn.cu`` ``ghost_bn_fwd``), the backward forms the masked
cotangent, its two reductions and dX (+ dR) in another (K2,
``ghost_bn_bwd``).  On a CPU tensor the same functions run their plain
PyTorch versions (:func:`_gbn_fwd_plain`, :func:`_gbn_bwd_plain`, ports of
``_gbn_ref`` and ``_gbn_bwd_jnp``); on a CUDA tensor they launch the
kernels or raise.  Both kernels walk the contiguous runs of a few
channels of ``csrc/ghost_bn_walk.cuh`` and stage a block's runs once in
shared memory, split over a thread-block cluster where they exceed one
SM (:func:`ghost_bn_plan`), so each input is read from device memory
once; odd shapes take a two-read form of the same kernels (the note of
``csrc/ghost_bn.cu``).  :func:`bn_copy` (K7, ``csrc/bn_copy.cu``, port
of ``tools/bn_kernel_bench.py``'s ``_call_copy``) copies an activation
over the same walk: the ceiling of that walk, the yardstick of K1 and K2
in ``tools/bn_kernel_bench_torch.py``.

The group size is the reference's, not a free choice: the TPU plan picks
it from the divisors of N under the caller's cap, shaped by the TPU's
VMEM budget (:func:`ghost_group`).  Statistics over another group would
be another function.
"""
from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["ghost_bn_act", "ghost_bn_stats_merge", "ghost_group",
           "ghost_bn_fwd", "ghost_bn_bwd", "ghost_bn_plan", "bn_copy",
           "bn_copy_channels"]

# ---------------------------------------------------------------------------
# the reference's group selection (fused_bn.py _plan, _gbn_ref)
# ---------------------------------------------------------------------------

#: fused_bn.py _WINDOW_BUDGET: the TPU's double-buffered VMEM window budget
_WINDOW_BUDGET = 104 * 1024 * 1024
#: fused_bn.py _MAX_TILES: the spatial-tiling cap
_MAX_TILES = 16


def _rup(x, m):
    return -(-x // m) * m


def ghost_group(n, c, h, w, itemsize, group=0, has_res=False,
                donate_res=False, dual=False):
    """The ghost group size the reference uses for one BN layer.

    This is ``fused_bn.py``'s rule, copied as plain Python: ``_plan``'s
    selection (the VMEM window arithmetic included, since it decides the
    group at some f32 shapes), and, where ``_plan`` places no kernel,
    ``_gbn_ref``'s rule (the largest divisor of N at most ``group or
    32``).  ``itemsize`` is the activation's bytes per element."""
    n, c, l = int(n), int(c), int(h) * int(w)
    group = int(group)
    sub = 16 if itemsize == 2 else 8

    def padded(a_blk, b_blk, rows=l):
        return rows * _rup(a_blk, sub) * _rup(b_blk, 128) * itemsize

    def fits(nwin, a_blk, b_blk, rows=l):
        return nwin * 2 * padded(a_blk, b_blk, rows) <= _WINDOW_BUDGET

    fw = (3 - (1 if donate_res else 0)) if has_res else 2
    bw = (4 if dual else 3) if has_res else 2
    picked = None
    if c >= 128 or n > 128:
        cap = min(group if group else 32, n)
        ngs = sorted((g for g in range(1, cap + 1) if n % g == 0),
                     key=lambda g: (g % sub == 0, g), reverse=True)
        best_fwd = None
        for ng in ngs:
            if fits(fw, ng, c):
                if fits(bw, ng, c):
                    return ng
                if best_fwd is None:
                    best_fwd = ng
        fold = 128 // c if (c < 128 and 128 % c == 0) else 1
        if fold > 1 and l % fold == 0:
            for ng in ngs:
                if fits(fw, ng, fold * c, l // fold):
                    return ng

        def tiles(nwin, ng):
            return any(l % nt == 0 and fits(nwin, ng, c, l // nt)
                       for nt in range(2, _MAX_TILES + 1))

        if best_fwd is not None and tiles(bw, best_fwd):
            return best_fwd
        for ng in ngs:
            if tiles(fw, ng):
                return ng
        picked = best_fwd
    elif not (group and group < n):
        cb = c
        while cb > 0 and not fits(fw, cb, n):
            cb -= sub
            while cb > 0 and c % cb:
                cb -= 1
        if cb > 0:
            picked = n
    if picked is not None:
        return picked
    ng = min(n, group or 32)
    while n % ng:
        ng -= 1
    return ng


def ghost_bn_stats_merge(m, v):
    """(G, C) group stats -> (C,) whole-batch population stats by the law
    of total variance (fused_bn.py ghost_bn_stats_merge)."""
    bm = m.mean(dim=0)
    bv = (v + m * m).mean(dim=0) - bm * bm
    return bm, torch.clamp_min(bv, 0.0)


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _gbn_fwd_plain(x, gamma, beta, residual, eps, act, ng):
    """Port of fused_bn.py ``_gbn_ref`` at a given group size."""
    n, c, h, w = x.shape
    g = n // ng
    x32 = x.float().reshape(g, ng, c, h, w)
    m = x32.mean(dim=(1, 3, 4))
    v = torch.clamp_min((x32 * x32).mean(dim=(1, 3, 4)) - m * m, 0.0)
    rstd = torch.rsqrt(v + eps)
    g32 = gamma.float()
    scale = (g32[None] * rstd)[:, None, :, None, None]
    shift = (beta.float()[None] - m * g32[None] * rstd)[:, None, :, None, None]
    y = (x32 * scale + shift).reshape(n, c, h, w)
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype), m, v


def _gbn_bwd_plain(gy, gy2, x, y, gamma, beta, m, v, eps, act, ng):
    """Port of fused_bn.py ``_gbn_bwd_jnp``; ``gy2`` (the dual exit's
    second cotangent, or None) is summed in f32 as the kernels do.
    Returns (dx, dgamma, dbeta, dr) with the (G, C) partials summed."""
    n, c, h, w = x.shape
    g = n // ng
    x5 = x.float().reshape(g, ng, c, h, w)
    gy5 = gy.float().reshape(g, ng, c, h, w)
    if gy2 is not None:
        gy5 = gy5 + gy2.float().reshape(g, ng, c, h, w)
    mb = m.reshape(g, 1, c, 1, 1)
    rstd = torch.rsqrt(v + eps).reshape(g, 1, c, 1, 1)
    gam = gamma.float().reshape(1, 1, c, 1, 1)
    xhat = (x5 - mb) * rstd
    if act == "relu":
        if y is not None:
            keep = y.float().reshape(g, ng, c, h, w) > 0
        else:
            keep = (xhat * gam + beta.float().reshape(1, 1, c, 1, 1)) > 0
        gp = torch.where(keep, gy5, torch.zeros((), dtype=gy5.dtype,
                                                device=gy5.device))
    else:
        gp = gy5
    cnt = ng * h * w
    db = gp.sum(dim=(1, 3, 4))
    dg = (gp * xhat).sum(dim=(1, 3, 4))
    dx = (gam * rstd * (gp - (db.reshape(g, 1, c, 1, 1)
                              + xhat * dg.reshape(g, 1, c, 1, 1)) / cnt))
    dr = gp.reshape(n, c, h, w).to(x.dtype) if y is not None else None
    return dx.reshape(n, c, h, w).to(x.dtype), dg.sum(0), db.sum(0), dr


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_act(x, others, ng):
    if x.dim() != 4:
        raise ValueError("ghost BN takes (N, C, H, W), got %s"
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("ghost BN kernels take float32 or bfloat16, got %s"
                        % x.dtype)
    n = x.shape[0]
    if ng < 1 or n % ng:
        raise ValueError("group %d does not divide N=%d" % (ng, n))
    for name, t in others.items():
        if t is None:
            continue
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError("%s must match x (%s %s), got %s %s"
                             % (name, tuple(x.shape), x.dtype,
                                tuple(t.shape), t.dtype))
        if t.device != x.device:
            raise ValueError("%s is on %s, x on %s" % (name, t.device,
                                                       x.device))


def _on_card(t):
    """True where K1 and K2 run: a CUDA tensor."""
    return t.device.type == "cuda"


def _check_device(x):
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError("ghost BN runs on cuda or cpu, got %s" % x.device)


def _meta_stats(x, ng):
    """Empty (N/ng, C) f32 statistics on ``meta`` (shape inference)."""
    return torch.empty((x.shape[0] // ng, x.shape[1]), dtype=torch.float32,
                       device="meta")


def _dense(t):
    """An NCHW operand as K1/K2 read it: ``t`` where it is contiguous
    (None stays None), else one contiguous copy (a permuted or
    ``channels_last`` tensor, a strided view: JAX arrays have no strides,
    so the reference computes them).  A storage offset off the 16-byte
    grid needs no copy: the kernels take it in their two-read form."""
    return None if t is None else t.contiguous()


def _check_cuda(device, tensors, vecs):
    """``tensors``: NCHW operands (None allowed); ``vecs``: name ->
    (tensor, shape) of the f32 per-channel or per-group operands."""
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError("%s must be contiguous NCHW" % name)
    for name, (t, shape) in vecs.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != device:
            raise ValueError("%s must be contiguous float32 %s on %s, got "
                             "%s %s on %s" % (name, shape, device, t.dtype,
                                              tuple(t.shape), t.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def ghost_bn_fwd(x, gamma, beta, residual, eps, act, ng):
    """``(y, mean, var)``: y in x's dtype, mean and var (N/ng, C) f32.
    CUDA tensors go through K1 (x and the residual copied first where
    they are not contiguous NCHW); CPU tensors through the plain
    version; ``meta`` tensors get empty outputs (shape inference)."""
    _check_act(x, {"residual": residual}, ng)
    if act not in ("relu", "none"):
        raise ValueError("act must be 'relu' or 'none', got %r" % (act,))
    _check_device(x)
    if x.device.type == "meta":
        return torch.empty_like(x), _meta_stats(x, ng), _meta_stats(x, ng)
    if not _on_card(x):
        return _gbn_fwd_plain(x, gamma, beta, residual, eps, act, ng)
    n, c, h, w = x.shape
    x, residual = _dense(x), _dense(residual)
    _check_cuda(x.device, {"x": x, "residual": residual},
                {"gamma": (gamma, (c,)), "beta": (beta, (c,))})
    groups = n // ng
    if groups > 65535:
        raise ValueError("at most 65535 ghost groups per launch, got %d"
                         % groups)
    y = torch.empty_like(x)
    mean = torch.empty((groups, c), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _kernels.KERNELS["ghost_bn_fwd"].launch(
        x.device, _DTYPE_CODE[x.dtype], _ptr(x), _ptr(residual), _ptr(gamma),
        _ptr(beta), _ptr(y), _ptr(mean), _ptr(var), groups, c, h * w, ng,
        float(eps), 1 if act == "relu" else 0)
    return y, mean, var


def ghost_bn_bwd(gy, gy2, x, y, gamma, beta, mean, var, eps, act, ng):
    """``(dx, dgamma, dbeta, dr)``.  ``y`` is the saved output of a
    residual form (its ReLU mask; ``dr`` is then the masked cotangent),
    None otherwise; ``gy2`` is the dual exit's second cotangent or None.
    CUDA tensors go through K2 (the NCHW operands copied first where they
    are not contiguous); CPU tensors through the plain version; ``meta``
    tensors get empty outputs."""
    _check_act(x, {"gy": gy, "gy2": gy2, "y": y}, ng)
    _check_device(x)
    if x.device.type == "meta":
        c = x.shape[1]
        vec = torch.empty((c,), dtype=torch.float32, device="meta")
        return (torch.empty_like(x), vec, vec.clone(),
                torch.empty_like(x) if y is not None else None)
    if not _on_card(x):
        return _gbn_bwd_plain(gy, gy2, x, y, gamma, beta, mean, var, eps,
                              act, ng)
    n, c, h, w = x.shape
    groups = n // ng
    gy, gy2, x, y = _dense(gy), _dense(gy2), _dense(x), _dense(y)
    _check_cuda(x.device, {"gy": gy, "gy2": gy2, "x": x, "y": y},
                {"gamma": (gamma, (c,)), "beta": (beta, (c,)),
                 "mean": (mean, (groups, c)), "var": (var, (groups, c))})
    dx = torch.empty_like(x)
    dr = torch.empty_like(x) if y is not None else None
    dg = torch.empty((groups, c), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    _kernels.KERNELS["ghost_bn_bwd"].launch(
        x.device, _DTYPE_CODE[x.dtype], _ptr(gy), _ptr(gy2), _ptr(x), _ptr(y),
        _ptr(gamma), _ptr(beta), _ptr(mean), _ptr(var), _ptr(dx), _ptr(dr),
        _ptr(dg), _ptr(db), groups, c, h * w, ng, float(eps),
        1 if act == "relu" else 0)
    return dx, dg.sum(0), db.sum(0), dr


def ghost_bn_plan(x, ng, tensors):
    """``(kc, cs)`` of a K1/K2 launch on ``x`` at ghost group ``ng``, as the
    built kernels plan it: the channels a block owns, and the CTAs of the
    cluster that shares a block's runs of ``tensors`` staged tensors (K1 1;
    K2 2, 3 with a second cotangent), 0 where the launch takes the
    two-read form (for tensors that start on 16 bytes).  Builds the
    library if needed; launches nothing."""
    n, c, h, w = x.shape
    args = (_DTYPE_CODE[x.dtype], n // ng, c, h * w, ng)
    return (_kernels.query("ghost_bn_channels", *args),
            _kernels.query("ghost_bn_cluster", *args, int(tensors)))


def bn_copy_channels(x, ng):
    """The channels ``kc`` a block of K7 copies for ``x`` at ghost group
    ``ng``, as the built kernel picks them (``walk_channels`` of
    ``csrc/ghost_bn_walk.cuh``, through the ``bn_copy_channels`` entry).
    Builds the library if needed; launches nothing."""
    n, c, h, w = x.shape
    return _kernels.query("bn_copy_channels", _DTYPE_CODE[x.dtype], n // ng,
                          c, h * w, ng)


def bn_copy(x, ng):
    """A copy of the NCHW activation ``x`` (K7, ``csrc/bn_copy.cu``) at
    ghost group ``ng``: block (cb, g) copies the ng contiguous runs of
    :func:`bn_copy_channels` channels of ghost group g, 16 bytes a thread.  It
    is the ceiling of that walk, the bandwidth yardstick of K1 and K2.
    CUDA tensors go through K7; CPU tensors through the plain version,
    ``x.clone()``."""
    _check_act(x, {}, ng)
    if x.device.type == "cpu":
        return x.clone()
    if x.device.type != "cuda":
        raise ValueError("bn_copy runs on cuda or cpu, got %s" % x.device)
    n, c, h, w = x.shape
    _check_cuda(x.device, {"x": x}, {})
    groups = n // ng
    if groups > 65535:
        raise ValueError("at most 65535 ghost groups per launch, got %d"
                         % groups)
    y = torch.empty_like(x)
    _kernels.KERNELS["bn_copy"].launch(
        x.device, _DTYPE_CODE[x.dtype], _ptr(x), _ptr(y), groups, c, h * w,
        ng)
    return y


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _GhostBN(torch.autograd.Function):
    """Forward K1, backward K2.  The stat outputs carry no gradient (the
    reference's VJP for them is zero).  The dual form returns ``y`` and a
    view of it, so autograd keeps the two cotangents apart and K2 sums
    them on load (returning the same tensor twice would merge them)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps, act, ng, dual):
        y, m, v = ghost_bn_fwd(x, gamma, beta, residual, eps, act, ng)
        has_res = residual is not None
        ctx.save_for_backward(x, y if has_res else None, gamma, beta, m, v)
        ctx.cfg = (eps, act, ng, dual, has_res)
        ctx.mark_non_differentiable(m, v)
        if dual:
            return y, y.view_as(y), m, v
        return y, m, v

    @staticmethod
    def backward(ctx, gy, *rest):
        x, y, gamma, beta, m, v = ctx.saved_tensors
        eps, act, ng, dual, has_res = ctx.cfg
        gy2 = rest[0].contiguous() if dual else None
        dx, dg, db, dr = ghost_bn_bwd(gy.contiguous(), gy2, x, y, gamma, beta,
                                      m, v, eps, act, ng)
        return (dx, dg.to(gamma.dtype), db.to(beta.dtype),
                dr if has_res else None, None, None, None, None)


def ghost_bn_act(x, gamma, beta, residual=None, eps=1e-3, act="relu",
                 group=0, donate_residual=False, dual_out=False, batch=None):
    """Fused ghost-BN (+residual) (+ReLU) (fused_bn.py ghost_bn_act).

    x: (N, C, H, W).  Returns ``(y, group_mean, group_var)`` with (G, C)
    stats, or ``(y, y_shortcut, group_mean, group_var)`` with
    ``dual_out=True``.  ``group`` is a cap; :func:`ghost_group` picks the
    reference's group under it.  ``donate_residual`` declares the
    residual dead after this layer; it takes part in the group choice, as
    in the reference, but y is written to a fresh tensor here (autograd
    forbids writing over a tensor it saved).

    ``batch`` is the batch the group is picked for, N by default; in a
    data-parallel step it is the global batch, of which ``x`` is one
    rank's slice.  The group must then divide N, so that every group lies
    inside one rank and needs no communication."""
    n, c, h, w = x.shape
    donate = bool(donate_residual) and residual is not None
    batch = n if batch is None else int(batch)
    ng = ghost_group(batch, c, h, w, x.element_size(), int(group),
                     residual is not None, donate, bool(dual_out))
    if n % ng:
        raise ValueError(
            "ghost group %d (the reference's for the global batch %d) does "
            "not divide this rank's batch %d: a group would span two ranks; "
            "make the per-rank batch a multiple of the group"
            % (ng, batch, n))
    return _GhostBN.apply(x, gamma, beta, residual, float(eps), act, ng,
                          bool(dual_out))
