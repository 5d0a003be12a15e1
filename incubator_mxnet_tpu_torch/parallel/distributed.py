"""Multi-process bootstrap over ``torch.distributed`` (port of
``incubator_mxnet_tpu/parallel/distributed.py``).

``tools/launch_torch.py`` starts N processes with the ``DMLC_*`` rendezvous
environment (``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` name the
coordinator, ``DMLC_NUM_WORKER`` the world size, ``DMLC_WORKER_ID`` this
rank); :func:`initialize` reads it and calls
``torch.distributed.init_process_group`` over TCP.  One process drives
one device: rank r uses ``cuda:(r % device_count)``, or the CPU when the
caller asks for it (:func:`local_device`).

The backend follows the devices, with no knob: NCCL when every rank has
a card of its own, gloo otherwise (the CPU, or several ranks sharing a
card, which NCCL refuses; gloo then stages CUDA tensors through the
host).  The rendezvous and every collective get a finite timeout, so a
dead peer fails the job instead of hanging it.

Everything here runs in a single process too: :func:`initialize` returns
1 at world size 1 without creating a group, :func:`barrier` returns at
once, and :func:`make_process_mesh` is :func:`~.mesh.make_mesh`.  A group
created by the caller (``init_process_group`` called directly, at any
world size) is used as it is.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["DistributedInitError", "barrier", "backend",
           "collectives_supported", "initialize", "is_initialized",
           "local_device", "make_process_mesh", "min_over_processes",
           "process_count", "process_index", "resplit_iter_state"]

#: seconds a rendezvous or a collective may wait for its peers
DEFAULT_TIMEOUT = 300.0

_log = logging.getLogger(__name__)


class DistributedInitError(RuntimeError):
    """The multi-process rendezvous failed (coordinator unreachable,
    world-size/rank mismatch, a peer that never arrived)."""


_INITIALIZED = False
_BARRIER_COUNT = 0


def _env_world() -> int:
    return int(os.environ.get("DMLC_NUM_WORKER", "1"))


def _env_rank() -> int:
    return int(os.environ.get("DMLC_WORKER_ID", "0"))


def is_initialized() -> bool:
    """True once this process belongs to a process group."""
    return _INITIALIZED or dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 in a single-process run)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """World size (1 in a single-process run)."""
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The group's backend (``"nccl"`` or ``"gloo"``), None without one."""
    return dist.get_backend() if is_initialized() else None


def local_device(device=None, rank=None) -> torch.device:
    """The device rank ``rank`` (default: this process's) drives:
    ``cuda:(rank % device_count)``, or the CPU when ``device`` says so.
    Without a card and without ``device="cpu"`` it raises, as every entry
    point of the port does."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a rank drives a card by default; pass "
            "device='cpu' to run the ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    r = process_index() if rank is None else int(rank)
    return torch.device("cuda", r % torch.cuda.device_count())


def _choose_backend(num_processes: int, device) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    if num_processes > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _raw_initialize(coordinator: str, num_processes: int, rank: int,
                    timeout: float, backend_name: str) -> None:
    """The ``init_process_group`` call, module-level so a test can put a
    failing coordinator in its place."""
    dist.init_process_group(
        backend_name, init_method="tcp://%s" % coordinator,
        world_size=num_processes, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout)))


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: Optional[float] = None, device=None) -> int:
    """Rendezvous this process with its peers (idempotent); returns the
    world size.

    Arguments default to the ``DMLC_*`` environment of
    ``tools/launch_torch.py``.  A world size of 1 returns 1 at once WITHOUT
    latching, so a later call with a real topology still works.
    ``timeout`` (seconds, default :data:`DEFAULT_TIMEOUT`) bounds the
    rendezvous and every later collective.  ``device="cpu"`` makes the
    ranks CPU processes (gloo); otherwise each drives its card.

    A failed rendezvous raises :class:`DistributedInitError` naming the
    coordinator and the rank, with the backend's error as ``__cause__``.
    """
    global _INITIALIZED
    if is_initialized():
        _INITIALIZED = True
        return dist.get_world_size()
    num_processes = int(num_processes if num_processes is not None
                        else _env_world())
    if num_processes <= 1:
        return 1
    if coordinator is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9091")
        coordinator = "%s:%s" % (uri, port)
    rank = int(process_id if process_id is not None else _env_rank())
    timeout = DEFAULT_TIMEOUT if timeout is None else float(timeout)
    name = _choose_backend(num_processes, device)
    if name == "nccl":
        torch.cuda.set_device(local_device(device, rank))
    try:
        _raw_initialize(coordinator, num_processes, rank, timeout, name)
    except Exception as e:
        raise DistributedInitError(
            "torch.distributed rendezvous failed: process %d/%d could not "
            "join coordinator %s within %.0f s (%s).  Check that the "
            "coordinator process is up, the DMLC_* environment matches on "
            "every host, and no stale process holds the port."
            % (rank, num_processes, coordinator, timeout, e)) from e
    _INITIALIZED = True
    _log.info("rank %d/%d joined %s over %s", rank, num_processes,
              coordinator, name)
    return num_processes


def barrier(tag: Optional[str] = None) -> None:
    """Block until every process reaches this barrier (no-op without a
    group).  ``tag`` names the sync point in errors."""
    global _BARRIER_COUNT
    if not is_initialized():
        return
    _BARRIER_COUNT += 1
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except Exception as e:
        raise RuntimeError("barrier %r (#%d) failed on rank %d: %s"
                           % (tag, _BARRIER_COUNT, process_index(), e)) \
            from e


def min_over_processes(values) -> List[int]:
    """The elementwise min of a few ints over every process of the group
    (``values`` themselves without one): how the processes agree on a
    choice each made alone, such as the checkpoint a restore loads."""
    values = [int(v) for v in values]
    if not is_initialized():
        return values
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return [int(v) for v in t.tolist()]


def collectives_supported() -> bool:
    """Whether cross-process collectives run here: always, on both
    backends (gloo and NCCL), and trivially without a group."""
    return True


def make_process_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A mesh over the processes: :func:`~.mesh.make_mesh` (which already
    spans every process of the group; ``-1`` infers the world size)."""
    return make_mesh(axes, devices=devices)


# ---------------------------------------------------------------------------
# elastic data-stream re-split (pure Python, as the reference's)
# ---------------------------------------------------------------------------

_PART_KEYS = ("part_index", "num_parts")


def _strip_part_stamps(state):
    """Copy of an iterator-state tree with every ``part_index``/
    ``num_parts`` stamp removed (recursively): the part-invariant core
    two shards of the same stream must agree on."""
    if isinstance(state, dict):
        return {k: _strip_part_stamps(v) for k, v in state.items()
                if k not in _PART_KEYS}
    if isinstance(state, (list, tuple)):
        return [_strip_part_stamps(v) for v in state]
    return state


def _restamp_parts(state, part_index: int, num_parts: int):
    """Copy of an iterator-state tree with every dict that carries the
    part stamping re-stamped to the new shard identity."""
    if isinstance(state, dict):
        out = {k: _restamp_parts(v, part_index, num_parts)
               for k, v in state.items()}
        if all(k in state for k in _PART_KEYS):
            out["part_index"] = int(part_index)
            out["num_parts"] = int(num_parts)
        return out
    if isinstance(state, (list, tuple)):
        return [_restamp_parts(v, part_index, num_parts) for v in state]
    return state


def resplit_iter_state(parts: Dict, part_index: int, num_parts: int):
    """Re-split per-process iterator states saved at N data shards onto
    the ``part_index``-th of ``num_parts`` restarted shards.

    ``parts`` maps saved rank (int or str: JSON keys) to that rank's
    ``state_dict()``.  At the same width each process takes its own part
    verbatim.  At another width every part must hold the same
    part-invariant state (replicated data, or a sharded reader at an
    epoch boundary), which is re-stamped with the new shard identity;
    parts that diverged raise ``ValueError`` naming the saved and the
    requested split instead of replaying or skipping data."""
    if not parts:
        raise ValueError("no saved iterator parts to re-split")
    by_rank = {int(k): v for k, v in parts.items()}
    saved_n = len(by_rank)
    if sorted(by_rank) != list(range(saved_n)):
        raise ValueError(
            "saved iterator parts are not contiguous ranks: %r"
            % (sorted(by_rank),))
    if not 0 <= int(part_index) < int(num_parts):
        raise ValueError("part_index %d outside num_parts %d"
                         % (part_index, num_parts))
    if int(num_parts) == saved_n:
        return by_rank[int(part_index)]
    cores = [json.dumps(_strip_part_stamps(by_rank[r]), sort_keys=True)
             for r in range(saved_n)]
    if any(c != cores[0] for c in cores[1:]):
        diverged = [r for r in range(1, saved_n) if cores[r] != cores[0]]
        raise ValueError(
            "iterator state saved at num_parts=%d cannot be re-split to "
            "num_parts=%d: parts %s diverged from part 0 (a sharded "
            "record stream mid-epoch holds different records per part). "
            "Resume at the saved width, or restart the epoch with fresh "
            "iterators at the new width."
            % (saved_n, num_parts, diverged))
    return _restamp_parts(by_rank[0], int(part_index), int(num_parts))
