"""Flash attention on the H100 (port of
``incubator_mxnet_tpu/parallel/flash_attention.py``).

``softmax(Q Kᵀ · scale [+ causal mask]) V`` without the (S, S) score
matrix: the forward keeps a running max ``m``, a running sum ``l`` and an
f32 accumulator per query row while K/V tiles stream past, and saves the
per-row log-sum-exp ``lse = m + log l``; the backward recomputes
``P = exp(S - lse)`` tile by tile.  Three hand-written kernels
(``csrc/flash_attention.cu``) do the work on a CUDA tensor: K4
``flash_attn_fwd``, K5 ``flash_attn_bwd_dq`` and K6 ``flash_attn_bwd_dkv``.
On a CPU tensor the same functions run their plain PyTorch versions
(:func:`_flash_fwd_plain`, :func:`_flash_bwd_plain`), which repeat the
Pallas kernels' arithmetic over the reference's tiles: the ``-1e30``
fill, the right-aligned causal mask ``j <= i + (Sk - Sq)``, p zeroed
where a row has seen no key, the ``1e-30`` floors of ``l``.

There is no ``interpret`` or ``use_pallas`` argument: the reference needs
them to pick between a Pallas kernel, its interpreter and XLA's fused
attention on one backend, while here the tensor's device decides.  A CUDA
tensor always goes through the kernels (no fallback); a CPU tensor always
through the plain versions.

``block_q``/``block_k`` tile the plain versions as they tile the Pallas
grid (clamped to divisors of the lengths, :func:`_fit_block`).  The CUDA
kernels use their own 64 x 64 tiles, fixed in the source, and mask the
ragged edge themselves.  The result does not depend on either tiling.
"""
from __future__ import annotations

import math

import torch

from .. import _kernels

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels keep up to 128 f32 accumulators per row (csrc note)
_MAX_HEAD_DIM = 128


def _fit_block(size, block):
    """Largest divisor of ``size`` that is <= ``block`` (flash_attention.py
    ``_fit_block``)."""
    block = min(block, size)
    while size % block:
        block -= 1
    return block


def _default_blocks(sk, block_q, block_k):
    """The reference's defaults: 128 x 128, and 256 x 512 from Sk >= 4096;
    explicit sizes win."""
    bq_d, bk_d = (256, 512) if sk >= 4096 else (128, 128)
    return (bq_d if block_q is None else int(block_q),
            bk_d if block_k is None else int(block_k))


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _tile_relevant(qi, ki, bq, bk, offset):
    """False iff tile (qi, ki) lies wholly above the causal diagonal
    (``_block_relevant``)."""
    return ki * bk <= qi * bq + bq - 1 + offset


def _masked_scores(q, k, scale, causal, qi, ki, bq, bk, offset):
    """``q kᵀ · scale`` of one tile, with the ``-1e30`` fill where the
    right-aligned causal mask hides a key (``_causal_mask``)."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if causal:
        rows = qi * bq + torch.arange(bq, device=q.device)[:, None]
        cols = ki * bk + torch.arange(bk, device=q.device)[None, :]
        s = torch.where(rows + offset >= cols, s,
                        torch.full((), _NEG_INF, device=q.device))
    return s


def _flash_fwd_plain(q, k, v, scale, causal, block_q=128, block_k=128):
    """The forward kernel's arithmetic (``_fwd_kernel``) over (BH, S, D)
    tensors.  Returns ``(out, lse)``: out in q's dtype, lse (BH, Sq) f32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bq, bk = _fit_block(sq, block_q), _fit_block(sk, block_k)
    offset = sk - sq
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    zero = torch.zeros((), device=q.device)
    for qi in range(sq // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        m = torch.full((bh, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((bh, bq, 1), device=q.device)
        acc = torch.zeros((bh, bq, d), device=q.device)
        for ki in range(sk // bk):
            if causal and not _tile_relevant(qi, ki, bq, bk, offset):
                continue
            cols = slice(ki * bk, (ki + 1) * bk)
            s = _masked_scores(qf[:, rows], kf[:, cols], scale, causal, qi,
                               ki, bq, bk, offset)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            # a row with no visible key yet: every score is the fill, so
            # exp would give 1s and emit mean(V); it contributes nothing
            p = torch.where(m_new > _NEG_INF / 2, p, zero)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vf[:, cols])
            m = m_new
        lf = torch.clamp_min(l, 1e-30)
        out[:, rows] = (acc / lf).to(q.dtype)
        lse[:, rows] = (m + torch.log(lf))[..., 0]
    return out, lse


def _bwd_tile(q, k, v, do, lse, delta, scale, causal, qi, ki, bq, bk, offset):
    """P and dS of one tile (``_bwd_dq_kernel``/``_bwd_dkv_kernel``): P
    recomputed from the saved lse and zeroed on the raw scores where the
    mask filled them (an empty row's lse is ~-1e30 and would blow exp up)."""
    s = _masked_scores(q, k, scale, causal, qi, ki, bq, bk, offset)
    p = torch.exp(s - lse[..., None])
    p = torch.where(s > _NEG_INF / 2, p, torch.zeros((), device=q.device))
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, block_q=128,
                        block_k=128):
    """dQ as ``_bwd_dq_kernel`` computes it: for each Q tile, sum dS K over
    the K tiles.  Returns dq in q's dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bq, bk = _fit_block(sq, block_q), _fit_block(sk, block_k)
    offset = sk - sq
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    for qi in range(sq // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        acc = torch.zeros((bh, bq, d), device=q.device)
        for ki in range(sk // bk):
            if causal and not _tile_relevant(qi, ki, bq, bk, offset):
                continue
            cols = slice(ki * bk, (ki + 1) * bk)
            _, ds = _bwd_tile(qf[:, rows], kf[:, cols], vf[:, cols],
                              dof[:, rows], lse[:, rows], delta[:, rows],
                              scale, causal, qi, ki, bq, bk, offset)
            acc = acc + torch.matmul(ds, kf[:, cols])
        dq[:, rows] = acc.to(q.dtype)
    return dq


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal, block_q=128,
                         block_k=128):
    """dK and dV as ``_bwd_dkv_kernel`` computes them: for each K tile, sum
    Pᵀ dO and dSᵀ Q over the Q tiles.  Returns (dk, dv) in k's and v's
    dtypes."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bq, bk = _fit_block(sq, block_q), _fit_block(sk, block_k)
    offset = sk - sq
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk = torch.empty((bh, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((bh, sk, d), dtype=v.dtype, device=v.device)
    for kj in range(sk // bk):
        cols = slice(kj * bk, (kj + 1) * bk)
        acc_k = torch.zeros((bh, bk, d), device=k.device)
        acc_v = torch.zeros((bh, bk, d), device=k.device)
        for qi in range(sq // bq):
            if causal and not _tile_relevant(qi, kj, bq, bk, offset):
                continue
            rows = slice(qi * bq, (qi + 1) * bq)
            p, ds = _bwd_tile(qf[:, rows], kf[:, cols], vf[:, cols],
                              dof[:, rows], lse[:, rows], delta[:, rows],
                              scale, causal, qi, kj, bq, bk, offset)
            acc_v = acc_v + torch.matmul(p.transpose(1, 2), dof[:, rows])
            acc_k = acc_k + torch.matmul(ds.transpose(1, 2), qf[:, rows])
        dk[:, cols] = acc_k.to(k.dtype)
        dv[:, cols] = acc_v.to(v.dtype)
    return dk, dv


def _flash_bwd_plain(q, k, v, do, lse, delta, scale, causal, block_q=128,
                     block_k=128):
    """``(dq, dk, dv)``: the two backward kernels' arithmetic (``_bwd``)."""
    dq = _flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, block_q,
                             block_k)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                  block_q, block_k)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, do=None, lse=None, delta=None):
    """Shape, dtype and device rules shared by the three wrappers; returns
    (bh, sq, sk, d)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention kernels take (BH, S, D) tensors")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError("k and v must be (%d, Sk, %d), got %s and %s"
                         % (bh, d, tuple(k.shape), tuple(v.shape)))
    if do is not None and do.shape != q.shape:
        raise ValueError("do must be %s, got %s" % (tuple(q.shape),
                                                    tuple(do.shape)))
    if sq < 1 or sk < 1:
        raise ValueError("flash attention needs Sq, Sk >= 1")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("flash attention takes float32 or bfloat16, got %s"
                        % q.dtype)
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t is not None and t.dtype != q.dtype:
            raise TypeError("%s is %s, q is %s" % (name, t.dtype, q.dtype))
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (bh, sq)):
            raise ValueError("%s must be float32 (%d, %d), got %s %s"
                             % (name, bh, sq, t.dtype, tuple(t.shape)))
    for name, t in (("k", k), ("v", v), ("do", do), ("lse", lse),
                    ("delta", delta)):
        if t is not None and t.device != q.device:
            raise ValueError("%s is on %s, q on %s" % (name, t.device,
                                                      q.device))
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError("flash attention runs on cuda or cpu, got %s"
                         % q.device)
    return bh, sq, sk, d


def _check_cuda(bh, d, tensors):
    """What the kernels take: D <= 128 with D % 8 == 0, contiguous inputs
    on 16-byte boundaries (they load 16 bytes a thread), at most 65535
    (batch x heads) rows of the grid."""
    if d > _MAX_HEAD_DIM or d % 8:
        raise ValueError("the flash attention kernels take head dims <= %d "
                         "with D %% 8 == 0, got %d" % (_MAX_HEAD_DIM, d))
    if bh > 65535:
        raise ValueError("at most 65535 batch x heads per launch, got %d"
                         % bh)
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.data_ptr() % 16:
            raise ValueError("%s must start on a 16-byte boundary" % name)


def flash_fwd(q, k, v, scale, causal, block_q=128, block_k=128):
    """``(out, lse)`` over (BH, S, D) tensors.  CUDA tensors go through K4;
    CPU tensors through the plain version (tiled by block_q x block_k)."""
    bh, sq, sk, d = _check(q, k, v)
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, scale, causal, block_q, block_k)
    _check_cuda(bh, d, {"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _kernels.KERNELS["flash_attn_fwd"].launch(
        q.device, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
        float(scale), int(bool(causal)))
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, block_q=128,
                 block_k=128):
    """dQ.  ``lse`` is the forward's, ``delta`` = rowsum(dO * O) in f32, both
    (BH, Sq).  CUDA tensors go through K5; CPU tensors through the plain
    version."""
    bh, sq, sk, d = _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal,
                                   block_q, block_k)
    _check_cuda(bh, d, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                        "delta": delta})
    dq = torch.empty_like(q)
    _kernels.KERNELS["flash_attn_bwd_dq"].launch(
        q.device, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), bh, sq, sk, d, float(scale), int(bool(causal)))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, block_q=128,
                  block_k=128):
    """``(dk, dv)``.  CUDA tensors go through K6; CPU tensors through the
    plain version."""
    bh, sq, sk, d = _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                    block_q, block_k)
    _check_cuda(bh, d, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                        "delta": delta})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _kernels.KERNELS["flash_attn_bwd_dkv"].launch(
        q.device, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, float(scale),
        int(bool(causal)))
    return dk, dv


# ---------------------------------------------------------------------------
# autograd and the public entry
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward K4 (saving q, k, v, out, lse); backward delta in torch, as
    the reference computes it in jnp outside its kernels, then K5 and K6."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        out, lse = flash_fwd(q, k, v, scale, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (scale, causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, block_q, block_k = ctx.cfg
        do = g.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, block_q,
                          block_k)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal,
                               block_q, block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None):
    """Flash attention over (B, H, S, D) tensors; differentiable.

    Returns softmax(Q Kᵀ · scale [+ causal mask]) V, with ``scale``
    defaulting to 1/sqrt(D).  Under ``causal`` the mask is right-aligned:
    query i sees key j iff j <= i + (Sk - Sq), and a query that sees no
    key gets 0."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    block_q, block_k = _default_blocks(sk, block_q, block_k)
    qf = q.reshape(b * h, s, d)
    kf = k.reshape(b * h, sk, d)
    vf = v.reshape(b * h, sk, d)
    out = _FlashAttention.apply(qf, kf, vf, float(scale), bool(causal),
                                block_q, block_k)
    return out.reshape(b, h, s, d)
