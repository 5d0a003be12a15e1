"""Collectives over a mesh axis (port of
``incubator_mxnet_tpu/parallel/collectives.py``).

The reference's functions are XLA collectives inside ``shard_map``
bodies.  Here each process holds its own shard, and the functions are
eager ``torch.distributed`` calls over the axis's process group
(``mesh=None``: every process of the group), with the reference's
shape checks.  Without a process group (one process) they return their
input's value as a one-rank collective would.

Every call that reaches the backend adds one to :func:`call_counts`
under its name, as ``_kernels.launch_counts`` counts kernel launches;
the ``*_coalesced`` forms flatten a list of tensors per dtype and make
one call per dtype.  ``ppermute`` is composed from one ``all_reduce``
(a zero buffer with this rank's row filled: the sum is exact).

The single-tensor forms are differentiable, with the reference's
transposes, for the model-parallel layers (ring and Ulysses attention,
the pipeline, MoE), whose consumers every rank of the axis runs alike:
``ppermute``'s backward is the inverse permutation, ``alltoall``'s the
all-to-all with its axes swapped, ``allgather``'s keeps this rank's
part, ``allreduce``'s passes the gradient through; :func:`shard` (the
boundary into a sharded computation) all-gathers its gradient and
:func:`sum_grad` sums it.  A backward's collectives count as the
forward's do.  Every rank must run the same graph, so that the
backward issues the same collectives in the same order everywhere.

:func:`dp_scope` marks the forward and backward of a data-parallel step:
batch norm inside it takes the statistics of the whole global batch
(``ops.nn.batch_norm``), ghost batch norm checks its groups against the
local batch and defers its running statistics to the step's reduction
(:meth:`DataParallelScope.defer_stats`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["allreduce", "allgather", "reduce_scatter", "alltoall",
           "ppermute", "shard", "sum_grad", "axis_size", "axis_index",
           "pmean", "broadcast_from", "allreduce_coalesced",
           "reduce_scatter_coalesced", "allgather_coalesced", "call_counts",
           "reset_call_counts", "dp_scope", "current_dp",
           "DataParallelScope"]

_COUNTS: Dict[str, int] = {}


def call_counts() -> Dict[str, int]:
    """Collective calls made since the last reset, by name."""
    return dict(_COUNTS)


def reset_call_counts() -> None:
    _COUNTS.clear()


def _count(name):
    _COUNTS[name] = _COUNTS.get(name, 0) + 1


def _group(axis_name, mesh):
    """(process group, axis size, this process's index); a None group
    means no backend call (one process, no group)."""
    from .distributed import is_initialized

    if mesh is not None:
        g = mesh.group(axis_name)
        return g, mesh.shape[axis_name], mesh.axis_index(axis_name)
    if not is_initialized():
        return None, 1, 0
    return dist.group.WORLD, dist.get_world_size(), dist.get_rank()


def _src_rank(group, index):
    """The global rank of position ``index`` in ``group``."""
    return dist.get_global_rank(group, index) \
        if group is not dist.group.WORLD else index


def _check_dim(x, dim, axis_name, op, role, extra=0):
    """``dim`` must be a real dimension of ``x`` (``extra=1`` admits one
    past the end: an untiled gather stacks onto a NEW axis)."""
    ndim = x.dim()
    if not 0 <= dim < ndim + extra:
        raise ValueError(
            "%s over axis %r: %s %d is out of range for a %d-dimensional "
            "operand (shape %s)"
            % (op, axis_name, role, dim, ndim, tuple(x.shape)))


def _check_divisible(x, dim, axis_name, n, op, role):
    size = x.shape[dim]
    if size % n:
        raise ValueError(
            "%s over axis %r (size %d): %s dimension %d has size %d, "
            "which does not divide by the axis size — each rank must "
            "receive an equal shard (pad the dimension to a multiple of "
            "%d, or see the pad-and-slice path in "
            "parallel/train_step.py zero=1)"
            % (op, axis_name, n, role, dim, size, n))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        out = x.clone()
        if g is not None:
            _count("all_reduce")
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def allreduce(x, axis_name="dp", mesh=None):
    """Sum across the axis (ncclAllReduce; the dist_sync sum).
    Differentiable for consumers that every rank of the axis runs alike
    (replicated): the gradient passes through unchanged."""
    g, n, _ = _group(axis_name, mesh)
    return _AllReduce.apply(x, g)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.g), None


def sum_grad(x, axis_name="dp", mesh=None):
    """``x`` unchanged, its gradient summed over the axis: where each
    rank feeds a replicated value into its own part of a computation
    (its experts, its heads), the value's gradient is the sum of the
    parts' (the counterpart of :func:`allreduce`'s backward)."""
    g, _, _ = _group(axis_name, mesh)
    return _SumGrad.apply(x, g)


def pmean(x, axis_name="dp", mesh=None):
    """Mean across the axis."""
    _, n, _ = _group(axis_name, mesh)
    return allreduce(x, axis_name, mesh) / n


def _allgather(x, g, n, axis, tiled):
    x = x.contiguous()
    if g is None:
        out = x.unsqueeze(0)
    else:
        _count("all_gather")
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=g)
        out = out.view((n,) + tuple(x.shape))
    if not tiled:
        return out.movedim(0, axis).contiguous()
    return torch.cat(list(out.unbind(0)), dim=axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, n, r, axis, tiled):
        ctx.args = (r, axis, tiled, x.shape[axis] if tiled else 1)
        return _allgather(x, g, n, axis, tiled)

    @staticmethod
    def backward(ctx, grad):
        r, axis, tiled, per = ctx.args
        part = grad.narrow(axis, r * per, per) if tiled \
            else grad.select(axis, r)
        return part.contiguous(), None, None, None, None, None


def allgather(x, axis_name="dp", mesh=None, axis=0, tiled=True):
    """Gather every rank's shard, concatenated along ``axis`` (``tiled``)
    or stacked on a new axis ``axis`` in rank order.  Differentiable for
    a replicated consumer: the backward keeps this rank's part of the
    gradient."""
    _check_dim(x, axis, axis_name, "allgather", "concat",
               extra=0 if tiled else 1)
    g, n, r = _group(axis_name, mesh)
    return _AllGather.apply(x, g, n, r, axis, tiled)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, n, r, dim):
        ctx.args = (g, n, dim)
        per = x.shape[dim] // n
        return x.narrow(dim, r * per, per).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        g, n, dim = ctx.args
        return _allgather(grad, g, n, dim, True), None, None, None, None


def shard(x, axis_name="dp", mesh=None, dim=0):
    """This rank's 1/N of a replicated ``x`` along ``dim`` (the boundary
    into a sharded computation: ``shard_map``'s in_spec).  Its backward
    all-gathers the ranks' gradients of their parts, so the replicated
    ``x`` gets the whole gradient on every rank."""
    _check_dim(x, dim, axis_name, "shard", "shard")
    g, n, r = _group(axis_name, mesh)
    _check_divisible(x, dim, axis_name, n, "shard", "shard")
    return _Shard.apply(x, g, n, r, dim)


def reduce_scatter(x, axis_name="dp", mesh=None, scatter_dimension=0,
                   tiled=True):
    """Sum across the axis, then keep this rank's 1/N of
    ``scatter_dimension`` (ZeRO's gradient sharding); untiled, the
    dimension must be the axis size and is dropped."""
    _check_dim(x, scatter_dimension, axis_name, "reduce_scatter", "scatter")
    g, n, r = _group(axis_name, mesh)
    _check_divisible(x, scatter_dimension, axis_name, n, "reduce_scatter",
                     "scatter")
    if not tiled and x.shape[scatter_dimension] != n:
        raise ValueError(
            "reduce_scatter over axis %r (size %d), untiled: scatter "
            "dimension %d has size %d, not the axis size"
            % (axis_name, n, scatter_dimension, x.shape[scatter_dimension]))
    xs = x.detach().movedim(scatter_dimension, 0).contiguous()
    rows = xs.shape[0] // n
    if g is None:
        out = xs.clone()
    else:
        _count("reduce_scatter")
        out = torch.empty(xs.numel() // n, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xs.reshape(-1), group=g)
        out = out.view((rows,) + tuple(xs.shape[1:]))
    if not tiled:
        return out[0]
    return out.movedim(0, scatter_dimension)


def _alltoall(x, g, n, split_axis, concat_axis, tiled):
    xs = x.movedim(split_axis, 0)
    shape = xs.shape
    xs = xs.reshape((n, shape[0] // n) + tuple(shape[1:])).contiguous()
    if g is None:
        out = xs.clone()
    else:
        _count("all_to_all")
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs, group=g)
    chunks = [c.movedim(0, split_axis) for c in out.unbind(0)]
    if tiled:
        return torch.cat(chunks, dim=concat_axis)
    return torch.stack([c.squeeze(split_axis) for c in chunks],
                       dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, n, split_axis, concat_axis, tiled):
        ctx.args = (g, n, split_axis, concat_axis, tiled)
        return _alltoall(x, g, n, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, grad):
        g, n, split_axis, concat_axis, tiled = ctx.args
        return (_alltoall(grad, g, n, concat_axis, split_axis, tiled),
                None, None, None, None, None)


def alltoall(x, axis_name="dp", split_axis=0, concat_axis=0, mesh=None,
             tiled=True):
    """All-to-all (MoE dispatch): ``split_axis`` cut in N chunks, chunk j
    sent to rank j, the chunks received concatenated along
    ``concat_axis`` in rank order (``tiled``), or, untiled, the split
    dimension (of the axis size) dropped and the chunks stacked on a
    new ``concat_axis``.  Differentiable: the backward is the
    all-to-all with the two axes swapped."""
    _check_dim(x, split_axis, axis_name, "alltoall", "split")
    _check_dim(x, concat_axis, axis_name, "alltoall", "concat")
    g, n, _ = _group(axis_name, mesh)
    _check_divisible(x, split_axis, axis_name, n, "alltoall", "split")
    return _AllToAll.apply(x, g, n, split_axis, concat_axis, tiled)


def _validate_permutation(perm, n, axis_name):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    bad = sorted({r for r in srcs + dsts if not 0 <= r < n})
    if bad:
        raise ValueError("ppermute over axis %r (size %d): ranks %s are "
                         "outside the axis" % (axis_name, n, bad))
    for role, ranks in (("source", srcs), ("destination", dsts)):
        dup = sorted({r for r in ranks if ranks.count(r) > 1})
        if dup:
            raise ValueError("ppermute over axis %r: %s ranks %s appear "
                             "more than once" % (axis_name, role, dup))


def _ppermute(x, g, n, r, perm):
    src = {d: s for s, d in perm}.get(r)
    if g is None:
        return x.clone() if src is not None else torch.zeros_like(x)
    _count("ppermute")
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[r] = x
    dist.all_reduce(buf, group=g)
    return buf[src].clone() if src is not None else torch.zeros_like(x)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, n, r, perm):
        ctx.args = (g, n, r, [(d, s) for s, d in perm])
        return _ppermute(x, g, n, r, perm)

    @staticmethod
    def backward(ctx, grad):
        return _ppermute(grad, *ctx.args), None, None, None, None


def ppermute(x, axis_name="dp", perm=(), mesh=None):
    """Collective permute: rank s's ``x`` lands on rank d for each
    ``(s, d)`` in ``perm``; a rank no pair sends to gets zeros (the
    pipeline fill/drain pattern).  A malformed permutation (repeated
    sources or destinations, ranks outside the axis) raises.
    Differentiable: the backward is the inverse permutation, and a rank
    that sent nothing gets a zero gradient."""
    perm = [(int(s), int(d)) for s, d in perm]
    g, n, r = _group(axis_name, mesh)
    _validate_permutation(perm, n, axis_name)
    return _Ppermute.apply(x, g, n, r, perm)


def axis_size(axis_name="dp", mesh=None) -> int:
    return _group(axis_name, mesh)[1]


def axis_index(axis_name="dp", mesh=None) -> int:
    return _group(axis_name, mesh)[2]


def broadcast_from(x, axis_name="dp", src=0, mesh=None):
    """Rank ``src``'s ``x`` on every rank (ncclBcast)."""
    g, n, _ = _group(axis_name, mesh)
    if not 0 <= int(src) < n:
        raise ValueError("broadcast_from over axis %r (size %d): source %d "
                         "is outside the axis" % (axis_name, n, src))
    out = x.detach().clone().contiguous()
    if g is not None:
        _count("broadcast")
        dist.broadcast(out, src=_src_rank(g, int(src)), group=g)
    return out


# ---------------------------------------------------------------------------
# coalesced forms: one backend call per dtype for a list of tensors
# ---------------------------------------------------------------------------

def _buckets(tensors):
    """Positions of ``tensors`` grouped by (dtype, device), in order."""
    out = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out.values()


def allreduce_coalesced(tensors: Sequence[torch.Tensor], axis_name="dp",
                        mesh=None) -> List[torch.Tensor]:
    """The sum across the axis of each tensor, in one ``all_reduce`` per
    dtype over the flattened list (the counterpart of the reference's one
    compiled reduction program for a push batch)."""
    tensors = list(tensors)
    g, _, _ = _group(axis_name, mesh)
    if g is None:
        return [t.detach().clone() for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        _count("all_reduce")
        dist.all_reduce(flat, group=g)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def reduce_scatter_coalesced(tensors: Sequence[torch.Tensor],
                             axis_name="dp", mesh=None
                             ) -> List[torch.Tensor]:
    """Each tensor summed across the axis, this rank keeping its 1/N of
    the leading dim (which must divide by N), in one
    ``reduce_scatter`` per dtype."""
    tensors = list(tensors)
    g, n, r = _group(axis_name, mesh)
    for t in tensors:
        _check_dim(t, 0, axis_name, "reduce_scatter", "scatter")
        _check_divisible(t, 0, axis_name, n, "reduce_scatter", "scatter")
    if g is None:
        return [t.detach().clone() for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _buckets(tensors):
        # row j of the buffer holds every tensor's j-th shard
        rows = torch.cat([tensors[i].detach().reshape(n, -1) for i in idx],
                         dim=1)
        shard = torch.empty(rows.shape[1], dtype=rows.dtype,
                            device=rows.device)
        _count("reduce_scatter")
        dist.reduce_scatter_tensor(shard, rows.reshape(-1), group=g)
        sizes = [tensors[i].numel() // n for i in idx]
        for i, part in zip(idx, shard.split(sizes)):
            out[i] = part.view((tensors[i].shape[0] // n,)
                               + tuple(tensors[i].shape[1:]))
    return out


def allgather_coalesced(shards: Sequence[torch.Tensor], axis_name="dp",
                        mesh=None) -> List[torch.Tensor]:
    """Every rank's shard of each tensor, concatenated along the leading
    dim in rank order, in one ``all_gather`` per dtype."""
    shards = list(shards)
    g, n, _ = _group(axis_name, mesh)
    if g is None:
        return [s.detach().clone() for s in shards]
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for idx in _buckets(shards):
        flat = torch.cat([shards[i].detach().reshape(-1) for i in idx])
        full = torch.empty(n * flat.numel(), dtype=flat.dtype,
                           device=flat.device)
        _count("all_gather")
        dist.all_gather_into_tensor(full, flat, group=g)
        full = full.view(n, flat.numel())
        sizes = [shards[i].numel() for i in idx]
        for i, part in zip(idx, full.split(sizes, dim=1)):
            out[i] = part.reshape((n * shards[i].shape[0],)
                                  + tuple(shards[i].shape[1:]))
    return out


# ---------------------------------------------------------------------------
# the data-parallel scope of a step
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


class DataParallelScope:
    """The dp axis of the step being run: its ``mesh``, ``axis_name``,
    ``size`` and this process's ``index``, and the running statistics
    deferred to the step's reduction."""

    def __init__(self, mesh, axis_name):
        self.mesh = mesh
        self.axis_name = axis_name
        self.size = mesh.shape[axis_name]
        self.index = mesh.axis_index(axis_name)
        self._deferred = []

    def defer_stats(self, tensors, commit):
        """Hold this rank's f32 statistics ``tensors`` until the step
        reduces; ``commit`` then receives their means over the axis."""
        self._deferred.append((list(tensors), commit))

    def deferred_tensors(self) -> List[torch.Tensor]:
        return [t for ts, _ in self._deferred for t in ts]

    def commit(self, summed: Sequence[torch.Tensor]) -> None:
        """Hand each deferred commit its tensors' sums over the axis,
        divided by the axis size."""
        it = iter(summed)
        for ts, commit in self._deferred:
            commit(*[next(it) / self.size for _ in ts])
        self._deferred = []


def current_dp() -> Optional[DataParallelScope]:
    """The enclosing :func:`dp_scope`, or None."""
    return getattr(_SCOPE, "dp", None)


@contextlib.contextmanager
def dp_scope(mesh, axis_name="dp"):
    """Run the block as one rank of a data-parallel step over
    ``mesh``'s ``axis_name`` (this thread only); yields the scope."""
    prev = current_dp()
    _SCOPE.dp = DataParallelScope(mesh, axis_name)
    try:
        yield _SCOPE.dp
    finally:
        _SCOPE.dp = prev
