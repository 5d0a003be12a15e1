"""Expert parallelism: the mixture-of-experts FFN with experts sharded
over the ``ep`` axis of a process mesh (port of
``incubator_mxnet_tpu/parallel/moe.py``).

:func:`moe_ffn` is the reference's token-choice top-k FFN in dense math:
the router's softmax, its top k renormalised, GShard's k-major capacity
(every rank-1 choice before any rank-2 choice) with the positions counted
in int32, the tanh form of GELU (``jax.nn.gelu``'s default) and the
expert einsums over every token.  ``return_aux`` also returns the
Switch load-balancing loss over the decisions before capacity.

:func:`moe_ffn_sharded` runs the same function with each rank holding
E/n experts: the router runs on every rank alike, each rank its own
experts on all tokens, and one differentiable ``allreduce`` over the
axis sums the combine.  :func:`moe_ffn_local` is its body, for callers
that already hold this rank's experts (``MoEFFN`` in a train step whose
``param_shardings`` put the experts on ``ep``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import collectives

__all__ = ["moe_ffn", "moe_ffn_sharded", "moe_ffn_local",
           "load_balancing_loss", "dp_load_balancing_loss"]


def _one_hot(idx, n, dtype):
    return F.one_hot(idx, n).to(dtype)


def load_balancing_loss(probs, top_idx):
    """The Switch/GShard auxiliary loss over router decisions: probs (T,
    E) the router's softmax, top_idx (T, K) the chosen experts.  Returns
    ``E * sum_e f_e * p_e`` (1 for a uniform router), f the fraction of
    decisions sent to expert e (a count: no gradient), p the mean
    router probability."""
    num_experts = probs.shape[-1]
    sel = _one_hot(top_idx, num_experts, probs.dtype)
    f = sel.sum(dim=1).mean(dim=0) / sel.shape[1]
    p = probs.mean(dim=0)
    return num_experts * (f * p).sum()


def _top_k(probs, k):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, gate_w, top_k):
    """The router: (probs (T, E), renormalised top-k weights (T, K),
    top-k experts (T, K))."""
    probs = torch.softmax(x @ gate_w, dim=-1)
    top_p, top_idx = _top_k(probs, top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_idx


def _combine_weights(top_p, top_idx, num_experts, dtype, capacity_factor,
                    dp=None):
    """(T, E) weights of each token's expert outputs: the renormalised
    router weights of the decisions that fit their expert's capacity
    (``ceil(capacity_factor * T * K / E)``, k-major priority; None: no
    limit).  Under a data-parallel scope ``dp`` the tokens are this
    rank's slice of the global batch, and T and the positions are the
    global batch's, as the reference's one program counts them."""
    tokens, top_k = top_idx.shape
    disp = _one_hot(top_idx, num_experts, dtype)
    if capacity_factor is not None:
        n = dp.size if dp is not None else 1
        capacity = max(1, int(math.ceil(
            capacity_factor * tokens * n * top_k / num_experts)))
        # positions are counts: int32, not the activation dtype (a bf16
        # cumsum loses integers past 256 and keeps the wrong decisions)
        sel_i = (disp > 0).to(torch.int32).transpose(0, 1)  # (K, T, E)
        counts = sel_i.sum(dim=1)                           # (K, E)
        if n > 1:
            every = collectives.allgather(counts, dp.axis_name, dp.mesh,
                                          tiled=False)      # (n, K, E)
            before = every[:dp.index].sum(dim=0)
            counts = every.sum(dim=0)
        else:
            before = torch.zeros_like(counts)
        # k-major: every rank-k decision after all rank-k' < k ones
        base = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts \
            + before
        pos = torch.cumsum(sel_i, dim=1, dtype=torch.int32) - sel_i \
            + base[:, None, :]
        keep = (pos < capacity).transpose(0, 1).to(dtype)
        disp = disp * keep
    return torch.einsum("tk,tke->te", top_p.to(dtype), disp)


def _experts(x, w1, b1, w2, b2, combine):
    """The experts on every token, combined: (T, d)."""
    h = torch.einsum("td,edf->etf", x, w1) + b1[:, None, :]
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("etf,efd->etd", h, w2) + b2[:, None, :]
    return torch.einsum("etd,te->td", y, combine)


def moe_ffn(x, gate_w, w1, b1, w2, b2, top_k=1, capacity_factor=None,
            return_aux=False):
    """Token-choice MoE FFN.  x (T, d); gate_w (d, E); w1 (E, d, hidden);
    b1 (E, hidden); w2 (E, hidden, d); b2 (E, d).  With
    ``capacity_factor`` each expert takes at most ``ceil(capacity_factor
    * T * top_k / E)`` decisions; with ``return_aux`` the result is
    ``(out, load-balancing loss)``."""
    out, probs, top_idx = moe_ffn_local(x, gate_w, w1, b1, w2, b2, top_k,
                                        capacity_factor, axis_name=None)
    if return_aux:
        return out, load_balancing_loss(probs, top_idx)
    return out


def moe_ffn_local(x, gate_w, w1, b1, w2, b2, top_k=1, capacity_factor=None,
                  axis_name="ep", mesh=None, dp=None):
    """The MoE FFN with this rank's experts in hand: w1, b1, w2, b2 hold
    the E/n experts ``[r E/n, (r+1) E/n)`` of rank r of ``axis_name``
    (None: all E, no collective).  Returns ``(out, probs, top_idx)``;
    ``out`` is summed over the axis, and the gradients of x and gate_w
    are whole on every rank.  ``dp``: the data-parallel scope whose
    global batch the capacity counts (:func:`_combine_weights`)."""
    num_experts = gate_w.shape[-1]
    probs, top_p, top_idx = _route(x, gate_w, top_k)
    combine = _combine_weights(top_p, top_idx, num_experts, x.dtype,
                              capacity_factor, dp)
    if axis_name is None:
        return _experts(x, w1, b1, w2, b2, combine), probs, top_idx
    # this rank's experts' columns; the backward all-gathers them
    combine = collectives.shard(combine, axis_name, mesh, dim=1)
    part = _experts(collectives.sum_grad(x, axis_name, mesh), w1, b1, w2,
                    b2, combine)
    return collectives.allreduce(part, axis_name, mesh), probs, top_idx


def dp_load_balancing_loss(probs, top_idx, dp):
    """This rank's term of the load-balancing loss of the global batch
    under the data-parallel scope ``dp``: the step averages its ranks'
    losses, so the terms average to :func:`load_balancing_loss` of the
    whole batch, and so do their gradients.  f is counted over the
    global batch (one ``all_reduce``); the term is linear in this
    rank's router probabilities."""
    num_experts = probs.shape[-1]
    sel = _one_hot(top_idx, num_experts, probs.dtype)
    counts = collectives.allreduce(sel.sum(dim=(0, 1)).detach(),
                                   dp.axis_name, dp.mesh)
    tokens = probs.shape[0] * dp.size
    f = counts / tokens / sel.shape[1]
    return num_experts * (f * probs.sum(dim=0)).sum() / tokens * dp.size


def _check_sharded(gate_w, w1, b1, w2, b2, mesh, axis_name):
    if axis_name not in mesh.axis_names:
        raise ValueError(
            "moe_ffn_sharded: mesh axis %r is not one of the mesh's axes "
            "%s" % (axis_name, mesh.axis_names))
    for name, t, rank in (("w1", w1, 3), ("w2", w2, 3), ("b1", b1, 2),
                          ("b2", b2, 2)):
        if t.dim() != rank:
            raise ValueError(
                "moe_ffn_sharded(%s): the expert tensor is %d-dimensional "
                "(shape %s); its spec P(%r, ...) shards the expert dim of "
                "a %d-dimensional tensor" % (name, t.dim(), tuple(t.shape),
                                             axis_name, rank))
    n = mesh.shape[axis_name]
    if gate_w.shape[-1] % n:
        raise ValueError(
            "moe_ffn_sharded: %d experts do not divide over mesh axis %r "
            "of size %d" % (gate_w.shape[-1], axis_name, n))


def moe_ffn_sharded(x, gate_w, w1, b1, w2, b2, mesh, top_k=1,
                    axis_name="ep", capacity_factor=None, return_aux=False):
    """:func:`moe_ffn` with the experts sharded over ``axis_name`` of
    ``mesh``: every rank passes the whole (replicated) tensors, keeps
    its E/n experts, and gets the whole result."""
    _check_sharded(gate_w, w1, b1, w2, b2, mesh, axis_name)
    local = [collectives.shard(t, axis_name, mesh, dim=0)
             for t in (w1, b1, w2, b2)]
    out, probs, top_idx = moe_ffn_local(
        x, gate_w, *local, top_k=top_k, capacity_factor=capacity_factor,
        axis_name=axis_name, mesh=mesh)
    if return_aux:
        return out, load_balancing_loss(probs, top_idx)
    return out
