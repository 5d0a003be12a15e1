"""The single-device pieces of ``incubator_mxnet_tpu/parallel/ring_attention.py``.

:func:`attention_reference` is the dense softmax attention that the flash
kernels are held to, and :func:`_block_attn_update` one step of the
blockwise softmax that ring attention accumulates.  ``ring_attention``,
``ulysses_attention`` and ``sharded_self_attention`` move K/V blocks or
heads between devices; they wait for the port's ``torch.distributed``
layer (ROADMAP A8).  On one device ``ulysses_attention`` is
:func:`~.flash_attention.flash_attention` itself.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


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
