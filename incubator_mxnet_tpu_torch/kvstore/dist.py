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
than one worker runs over the asynchronous parameter host
(:mod:`.async_host`, the ``kvstore_dist_server.h:155`` analog): rank 0
hosts it on ``DMLC_PS_ROOT_PORT + 1``, every worker pushes to it with no
barrier (the update applies at once) and pulls its current value, so the
workers may take unequal numbers of steps.  At one worker ``dist_async``
is a single-worker store, as in the reference.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

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
                "Launch with tools/launch_torch.py -n <N> for real "
                "distributed training." % kv_type, stacklevel=3)
        self._async = (kv_type.startswith("dist_async")
                       and self.num_workers > 1)
        self._client = self._param_host = None
        if self._async:
            from .async_host import AsyncParamClient, AsyncParamHost

            port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")) + 1
            uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
            if self.rank == 0:
                self._param_host = AsyncParamHost(port, host=uri)
            self.barrier()  # the host listens before any client dials
            self._client = AsyncParamClient(uri, port)

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
        if self._async:
            # the host holds the authoritative copy: rank 0 seeds it (in
            # f32, the host's only dtype), every replica then pulls it
            if self.rank == 0:
                for k in keys:
                    self._client.init(k, self._store[k]._data.detach().to(
                        "cpu", torch.float32).numpy())
            self.barrier()
            for k in keys:
                self._pull_into_store(k)
            return
        for k in keys:
            self._store[k]._set_data(
                collectives.broadcast_from(self._store[k]._data, src=0))

    def _pull_into_store(self, k):
        """The host's value of ``k`` into this replica; returns it (f32,
        on the CPU)."""
        val = torch.from_numpy(self._client.pull(k))
        if k in self._store:
            cur = self._store[k]._data
            self._store[k]._set_data(val.to(device=cur.device,
                                            dtype=cur.dtype))
        return val

    def push(self, key, value, priority=0):
        """``dist_async``: merge this worker's values, compress them when
        set, and send each key to the host, which applies it at once; no
        collective and no barrier (kvstore_dist_server.h ApplyUpdates,
        async).  The other stores: the sum across the workers."""
        if not self._async:
            return super().push(key, value, priority)
        keys, values = self._norm_keys_vals(key, value)
        for k, v in zip(keys, values):
            merged = self._compress(k, self._merge(v))
            # the wire takes f32 only; bf16 gradients widen exactly
            self._client.push(k, merged.detach().to("cpu",
                                                     torch.float32).numpy())

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """``dist_async``: the host's current value (the other workers'
        pushes included, whatever their step); the other stores: the
        replica's."""
        if not self._async:
            return super().pull(key, out, priority, ignore_sparse)
        keys, outs = self._norm_keys_vals(key, out)
        for k, o in zip(keys, outs):
            val = self._pull_into_store(k)
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                t._set_data(val.to(device=t._data.device,
                                   dtype=t._data.dtype))
        return out

    def set_optimizer(self, optimizer):
        """``dist_async``: ship the optimizer to the host (the reference's
        ``kController`` command carrying it pickled), from rank 0 only,
        before any push; the other stores: run it in every replica."""
        if not self._async:
            return super().set_optimizer(optimizer)
        if self.rank == 0:
            self._client.set_optimizer(optimizer)
        self.barrier()  # no push before the optimizer is in place
        self._optimizer = optimizer

    def close(self):
        """Stop the async host and its clients (idempotent).  The host
        thread is a daemon, so a script that exits without this still
        ends; a second ``dist_async`` store in one process needs the port
        back first."""
        if self._client is not None:
            if self.rank == 0:
                self._client.stop_host()
            self._client.close()
            self._client = None
        if self._param_host is not None:
            self._param_host.stop()
            self._param_host = None

    def barrier(self):
        """A global barrier across the workers, after the local work."""
        super().barrier()
        _dist.barrier("kvstore")

    def _send_command_to_servers(self, head, body):
        """No servers exist; a barrier keeps the reference's synchronous
        command round-trip."""
        self.barrier()
