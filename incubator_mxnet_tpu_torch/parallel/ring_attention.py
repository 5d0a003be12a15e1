"""Sequence/context parallelism (port of
``incubator_mxnet_tpu/parallel/ring_attention.py``): ring attention and
Ulysses all-to-all over the ``sp`` axis of a process mesh.

- :func:`ring_attention`: blockwise-softmax attention where the K/V
  blocks rotate around the axis (n rotations by
  :func:`~.collectives.ppermute`), each rank accumulating its queries'
  attention over every block in f32 (:func:`_block_attn_update`), the
  causal mask taken on global positions;
- :func:`ulysses_attention`: all-to-all from sequence-sharded to
  head-sharded, the port's :func:`~.flash_attention.flash_attention` on
  the whole sequence (K4-K6 on the card), and back; on an axis of one
  process it is ``flash_attention`` itself;
- :func:`sharded_self_attention`: the host-level entry: takes and
  returns the global (B, H, S, D) tensors every rank holds, shards them
  on dim 2 (:func:`~.collectives.shard`), attends, and all-gathers the
  output, so every rank gets identical full q/k/v gradients and the
  model's other layers stay replicated.

:func:`attention_reference` is the dense softmax attention that the
flash kernels are held to.
"""
from __future__ import annotations

import math

import torch

from . import collectives
from .flash_attention import flash_attention

__all__ = ["attention_reference", "ring_attention", "ulysses_attention",
           "sharded_self_attention"]


def attention_reference(q, k, v, causal=False, scale=None):
    """Dense softmax attention (the correctness oracle).  q, k, v:
    (B, H, S, D).  The causal mask is ``tril(klen - qlen)``: right-aligned,
    and a query that sees no key gives NaN, as ``jax.nn.softmax`` over a
    row of -inf does."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.tril(torch.ones((qlen, klen), dtype=torch.bool,
                                     device=q.device), klen - qlen)
        s = torch.where(mask, s, torch.full((), float("-inf"),
                                            dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _block_attn_update(q, k, v, m, l, o, scale, mask=None):
    """One flash-attention accumulation step with a K/V block: returns the
    new running max ``m``, sum ``l`` and unnormalised output ``o``.
    Fully-masked rows keep ``m = -inf`` and contribute nothing."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg_inf = torch.full((), float("-inf"), dtype=s.dtype, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    if mask is not None:
        s = torch.where(mask, s, neg_inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (exp(-inf - -inf))
    safe_m = torch.where(torch.isneginf(m_new), zero, m_new)
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask, p, zero)
    alpha = torch.exp(torch.where(torch.isneginf(m), neg_inf, m - safe_m))
    alpha = torch.where(torch.isneginf(m), zero, alpha)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                   mesh=None):
    """Ring attention over ``axis_name`` of ``mesh`` (None: every process
    of the group).  q, k, v are this rank's sequence shards (B, H,
    S_local, D); the K/V blocks rotate around the ring, and the rank
    accumulates its queries' attention over every block with
    streaming-softmax state in f32; the output is in q's dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = collectives.axis_size(axis_name, mesh)
    my = collectives.axis_index(axis_name, mesh)
    b, h, s_local, _ = q.shape
    f32 = torch.float32
    m = torch.full((b, h, s_local), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros((b, h, s_local), dtype=f32, device=q.device)
    o = torch.zeros(q.shape, dtype=f32, device=q.device)
    qf = q.to(f32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    pos = torch.arange(s_local, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        # the source shard of the block after `step` rotations
        src = (my - step) % n
        mask = None
        if causal:
            q_pos = my * s_local + pos[:, None]
            k_pos = src * s_local + pos[None, :]
            mask = (k_pos <= q_pos)[None, None]
        m, l, o = _block_attn_update(qf, k_blk.to(f32), v_blk.to(f32),
                                     m, l, o, scale, mask)
        k_blk = collectives.ppermute(k_blk, axis_name, perm, mesh)
        v_blk = collectives.ppermute(v_blk, axis_name, perm, mesh)
    out = o / torch.clamp_min(l, 1e-38)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                      mesh=None):
    """Ulysses sequence parallelism: q, k, v sequence-sharded (B, H,
    S_local, D) with H divisible by the axis size are resharded to
    (B, H/n, S, D) by one all-to-all each, attend through
    :func:`~.flash_attention.flash_attention`, and go back."""
    if collectives.axis_size(axis_name, mesh) == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)

    def to_seq(x):
        return collectives.alltoall(x, axis_name, split_axis=1,
                                    concat_axis=2, mesh=mesh)

    out = flash_attention(to_seq(q), to_seq(k), to_seq(v), causal=causal,
                          scale=scale)
    return collectives.alltoall(out, axis_name, split_axis=2, concat_axis=1,
                                mesh=mesh)


def sharded_self_attention(q, k, v, mesh, seq_axis="sp", causal=False,
                           impl="ring", scale=None):
    """Sequence-parallel attention of the global (B, H, S, D) q, k, v
    that every rank of ``mesh``'s ``seq_axis`` holds: each rank takes its
    1/N of the sequence, runs ``impl`` (``"ring"`` or ``"ulysses"``),
    and the output is all-gathered back to (B, H, S, D) on every rank.
    Differentiable: every rank gets the same full q/k/v gradients."""
    if impl not in ("ring", "ulysses"):
        raise ValueError("impl must be 'ring' or 'ulysses', got %r"
                         % (impl,))
    fn = ring_attention if impl == "ring" else ulysses_attention
    ql, kl, vl = (collectives.shard(t, seq_axis, mesh, dim=2)
                  for t in (q, k, v))
    out = fn(ql, kl, vl, axis_name=seq_axis, causal=causal, scale=scale,
             mesh=mesh)
    return collectives.allgather(out, seq_axis, mesh, axis=2)
