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
           "ppermute", "axis_size", "axis_index", "pmean", "broadcast_from",
           "allreduce_coalesced", "reduce_scatter_coalesced",
           "allgather_coalesced", "call_counts", "reset_call_counts",
           "dp_scope", "current_dp", "DataParallelScope"]

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


def allreduce(x, axis_name="dp", mesh=None):
    """Sum across the axis (ncclAllReduce; the dist_sync sum)."""
    g, n, _ = _group(axis_name, mesh)
    out = x.detach().clone()
    if g is not None:
        _count("all_reduce")
        dist.all_reduce(out, group=g)
    return out


def pmean(x, axis_name="dp", mesh=None):
    """Mean across the axis."""
    _, n, _ = _group(axis_name, mesh)
    return allreduce(x, axis_name, mesh) / n


def allgather(x, axis_name="dp", mesh=None, axis=0, tiled=True):
    """Gather every rank's shard, concatenated along ``axis`` (``tiled``)
    or stacked on a new axis ``axis`` in rank order."""
    _check_dim(x, axis, axis_name, "allgather", "concat",
               extra=0 if tiled else 1)
    g, n, _ = _group(axis_name, mesh)
    x = x.detach().contiguous()
    if g is None:
        out = x.unsqueeze(0)
    else:
        _count("all_gather")
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=g)
        out = out.view((n,) + tuple(x.shape))
    if not tiled:
        return out.movedim(0, axis)
    return torch.cat(list(out.unbind(0)), dim=axis)


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


def alltoall(x, axis_name="dp", split_axis=0, concat_axis=0, mesh=None,
             tiled=True):
    """All-to-all (MoE dispatch): ``split_axis`` cut in N chunks, chunk j
    sent to rank j, the chunks received concatenated along
    ``concat_axis`` in rank order (``tiled``), or, untiled, the split
    dimension (of the axis size) dropped and the chunks stacked on a
    new ``concat_axis``."""
    _check_dim(x, split_axis, axis_name, "alltoall", "split")
    _check_dim(x, concat_axis, axis_name, "alltoall", "concat")
    g, n, _ = _group(axis_name, mesh)
    _check_divisible(x, split_axis, axis_name, n, "alltoall", "split")
    xs = x.detach().movedim(split_axis, 0)
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


def ppermute(x, axis_name="dp", perm=(), mesh=None):
    """Collective permute: rank s's ``x`` lands on rank d for each
    ``(s, d)`` in ``perm``; a rank no pair sends to gets zeros (the
    pipeline fill/drain pattern).  A malformed permutation (repeated
    sources or destinations, ranks outside the axis) raises."""
    perm = [(int(s), int(d)) for s, d in perm]
    g, n, r = _group(axis_name, mesh)
    _validate_permutation(perm, n, axis_name)
    src = {d: s for s, d in perm}.get(r)
    if g is None:
        return x.detach().clone() if src is not None \
            else torch.zeros_like(x)
    _count("ppermute")
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[r] = x.detach()
    dist.all_reduce(buf, group=g)
    return buf[src].clone() if src is not None else torch.zeros_like(x)


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
