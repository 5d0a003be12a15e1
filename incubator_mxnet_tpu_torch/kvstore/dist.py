"""The multi-process KVStore over ``torch.distributed`` (port of
``incubator_mxnet_tpu/kvstore/dist.py``): ``dist``, ``dist_sync``,
``dist_sync_device`` and ``dist_device_sync``.

There are no parameter servers.  Workers rendezvous through
:func:`~..parallel.distributed.initialize` (coordinator = the
``DMLC_PS_ROOT_URI:PORT`` that ``tools/launch.py`` exports), and the
"server state" is a replica kept bit-identical in every process: ``init``
takes rank 0's value everywhere, each push sums every key's merged value
across the processes in one ``all_reduce`` per dtype for the whole
batch (:func:`~..parallel.collectives.allreduce_coalesced`), and every
process then applies the same update to its replica.

Without a launcher environment (``DMLC_NUM_WORKER`` unset or 1, no
group) the store runs single-worker and warns.  ``dist_async`` with more
than one worker needs the asynchronous parameter host, ROADMAP A11, and
raises; at one worker it is a single-worker store, as in the reference.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..parallel import collectives
from ..parallel import distributed as _dist
from .kvstore import KVStore

__all__ = ["DistKVStore", "init_process_group", "is_initialized"]


def is_initialized() -> bool:
    return _dist.is_initialized()


def init_process_group(coordinator: Optional[str] = None,
                       num_workers: Optional[int] = None,
                       rank: Optional[int] = None) -> int:
    """Rendezvous this process with its peers (idempotent), from the
    ``DMLC_*`` environment by default; returns the world size.  The one
    bootstrap is :func:`~..parallel.distributed.initialize`: the store
    and the train step agree on whether this process is distributed."""
    return _dist.initialize(coordinator=coordinator,
                            num_processes=num_workers, process_id=rank)


class DistKVStore(KVStore):
    """``dist_sync`` and its aliases over ``torch.distributed``: every
    push is a sum across the processes and every replica stays
    bit-identical."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        if _dist._env_world() > 1 or is_initialized():
            init_process_group()
        else:
            warnings.warn(
                "KVStore type %r created without a launcher environment "
                "(DMLC_NUM_WORKER unset or 1) — running single-worker. "
                "Launch with tools/launch.py -n <N> for real distributed "
                "training." % kv_type, stacklevel=3)
        if kv_type.startswith("dist_async") and self.num_workers > 1:
            raise NotImplementedError(
                "KVStore %r with %d workers needs the asynchronous "
                "parameter host (kvstore/async_host.py), ROADMAP A11"
                % (kv_type, self.num_workers))

    @property
    def rank(self) -> int:
        return _dist.process_index()

    @property
    def num_workers(self) -> int:
        return _dist.process_count()

    def _reduce_batch_after_compress(self, keys, arrs):
        """Sum the push batch across the processes: one ``all_reduce`` per
        dtype over the flattened batch, split back per key."""
        return collectives.allreduce_coalesced(arrs)

    def init(self, key, value):
        """Rank 0's initial value wins everywhere (the reference's
        worker-0 push-init to the server)."""
        super().init(key, value)
        if not is_initialized():
            return
        keys, _ = self._norm_keys_vals(key, value)
        for k in keys:
            self._store[k]._set_data(
                collectives.broadcast_from(self._store[k]._data, src=0))

    def barrier(self):
        """A global barrier across the workers, after the local work."""
        super().barrier()
        _dist.barrier("kvstore")

    def _send_command_to_servers(self, head, body):
        """No servers exist; a barrier keeps the reference's synchronous
        command round-trip."""
        self.barrier()
