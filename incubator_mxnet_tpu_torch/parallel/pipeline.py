"""Pipeline parallelism over a ``pp`` axis of a process mesh, forward and
backward (port of ``incubator_mxnet_tpu/parallel/pipeline.py``).

Each rank holds one stage of a uniform-stage pipeline and runs the
``num_micro + n - 1`` ticks of the software-pipelined schedule: stage 0
injects the microbatches, every tick hands each stage's output to the
next through :func:`~.collectives.ppermute`, and the last stage's
outputs reach every rank through a masked ``allreduce``.  As in the
reference's masked ``lax.scan``, every rank computes its stage and calls
``ppermute`` on every tick, active or not, and the inactive ticks are
masked out with ``torch.where``: every rank then records the same graph,
so autograd's backward (the GPipe drain: cotangents hop stage to stage
through the inverse ``ppermute``, each rank summing its stage's
parameter gradients over the microbatches) issues the same collectives
in the same order on every rank.  ``remat=True`` wraps the stage in
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint``: only stage inputs are kept, and the stage recomputes
in the backward.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import collectives

__all__ = ["spmd_pipeline", "pipeline_apply", "stack_stage_params",
           "stage_congruence_mismatch"]


def stage_congruence_mismatch(first, stage, idx):
    """The congruence check shared by :func:`stack_stage_params` and the
    pipelined ``TrainStep``: ``first``/``stage`` are the per-parameter
    ``(shape, dtype)`` signatures of stage 0 and stage ``idx``.  Returns
    the reason the stages are not congruent, or None."""
    if len(stage) != len(first):
        return ("stage 0 has %d params, stage %d has %d"
                % (len(first), idx, len(stage)))
    for i, (a, b) in enumerate(zip(first, stage)):
        if tuple(a[0]) != tuple(b[0]) or a[1] != b[1]:
            return ("stage %d param %d is %s%s; stage 0 has %s%s"
                    % (idx, i, b[1], tuple(b[0]), a[1], tuple(a[0])))
    return None


def spmd_pipeline(stage_fn: Callable, stage_params, microbatches,
                  axis_name="pp", remat=False, mesh=None):
    """Run a uniform-stage pipeline over ``axis_name`` of ``mesh`` (None:
    every process of the group).  Differentiable.

    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``;
    ``stage_params`` are this rank's stage's parameters; ``microbatches``
    (num_micro, mb, ...) are the same on every rank (stage 0 consumes
    them).  Returns the last stage's outputs (num_micro, mb, ...) on
    every rank."""
    n = collectives.axis_size(axis_name, mesh)
    idx = collectives.axis_index(axis_name, mesh)
    num_micro = microbatches.shape[0]
    perm = [(i, i + 1) for i in range(n - 1)]
    params = list(stage_params)
    if remat:
        from torch.utils.checkpoint import checkpoint

        def fn(ps, x):
            return checkpoint(lambda h, *p: stage_fn(list(p), h), x, *ps,
                              use_reentrant=False)
    else:
        fn = stage_fn
    dev = microbatches.device

    def flag(b):
        return torch.tensor(bool(b), device=dev)

    first, last = flag(idx == 0), flag(idx == n - 1)
    buf = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(num_micro)]
    for t in range(num_micro + n - 1):
        inject = microbatches[min(max(t, 0), num_micro - 1)]
        x = torch.where(first, inject, buf)
        y = fn(params, x)
        # stage s works on ticks s .. s + num_micro - 1
        y = torch.where(flag(idx <= t < idx + num_micro), y, buf)
        if t >= n - 1:
            slot = t - (n - 1)
            outs[slot] = torch.where(last, y, outs[slot])
        buf = collectives.ppermute(y, axis_name, perm, mesh)
    out = torch.stack(outs)
    # the last stage's outputs on every rank (masked all-reduce)
    out = torch.where(last, out, torch.zeros_like(out))
    return collectives.allreduce(out, axis_name, mesh)


def stack_stage_params(stage_param_lists: Sequence[Sequence]):
    """Stack per-stage parameter lists along a new leading (pp) axis:
    ``stage_param_lists[s][i]`` is stage ``s``'s i-th parameter; the
    stages must be congruent (same count, shapes, dtypes).  Returns a
    list of ``(num_stages, *param_shape)`` tensors."""
    first = stage_param_lists[0]
    sig0 = [(tuple(a.shape), a.dtype) for a in first]
    for s, plist in enumerate(stage_param_lists[1:], 1):
        reason = stage_congruence_mismatch(
            sig0, [(tuple(b.shape), b.dtype) for b in plist], s)
        if reason:
            raise ValueError(
                "pipeline stages must be structurally identical "
                "(congruent): %s" % reason)
    return [torch.stack([plist[i] for plist in stage_param_lists])
            for i in range(len(first))]


def pipeline_apply(stage_fn, all_stage_params, x, mesh, num_micro=4,
                   axis_name="pp", remat=False):
    """Run the pipeline on batch ``x`` split into ``num_micro``
    microbatches: ``all_stage_params`` are stacked on a leading pp axis
    (:func:`stack_stage_params`), and each rank takes its own stage's
    slice (:func:`~.collectives.shard`: the stacked parameters get their
    whole gradient on every rank).  Returns the outputs (batch, ...) on
    every rank."""
    if x.shape[0] % num_micro:
        raise ValueError("batch %d not divisible into num_micro=%d"
                         % (x.shape[0], num_micro))
    micro = x.reshape((num_micro, x.shape[0] // num_micro)
                      + tuple(x.shape[1:]))
    local = [collectives.shard(p, axis_name, mesh, dim=0)[0]
             for p in all_stage_params]
    out = spmd_pipeline(stage_fn, local, micro, axis_name, remat=remat,
                        mesh=mesh)
    return out.reshape((-1,) + tuple(out.shape[2:]))
