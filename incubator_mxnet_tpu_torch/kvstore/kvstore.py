"""KVStore (port of ``incubator_mxnet_tpu/kvstore/kvstore.py``):
``create(name)`` for every type of the reference, ``init``/``push``/
``pull``/``pushpull``/``broadcast``, an optimizer or updater run on push
(``set_optimizer``/``set_updater``, the reference's
``update_on_kvstore``), and ``KVStoreBase.register`` for third-party
stores.

A push sums the values given for each key (the reference's per-device
reduce; one card here), hands the whole batch to
``_reduce_batch_after_compress`` (identity in one process; the
``dist_*`` store, :mod:`.dist`, sums it across the processes there),
then stores each sum or hands it to the updater (with
``set_gradient_compression``, each key's sum is 2-bit compressed, with
error feedback, before the batch is reduced); a pull copies the
stored value into each output.  ``horovod`` and ``tpu`` are local
stores, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["KVStore", "KVStoreBase", "create"]

_KV_TYPES = ("local", "local_allreduce_cpu", "local_allreduce_device",
             "device", "nccl", "dist", "dist_sync", "dist_async",
             "dist_sync_device", "dist_device_sync", "dist_async_device",
             "horovod", "tpu")


class KVStoreBase:
    """Registry of third-party stores: ``@KVStoreBase.register`` makes a
    class creatable by its lower-cased name."""

    _registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        KVStoreBase._registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def is_capable(capability: str) -> bool:
        return capability in ("optimized_pushpull",)


def create(name="local") -> "KVStore":
    """A store of type ``name``."""
    if not isinstance(name, str):
        raise TypeError("name must be a str")
    if name.lower() in KVStoreBase._registry:
        return KVStoreBase._registry[name.lower()]()
    if name not in _KV_TYPES:
        raise MXNetError("unknown KVStore type %r" % name)
    if name.startswith("dist"):
        from .dist import DistKVStore

        return DistKVStore(name)
    return KVStore(name)


class KVStore:
    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store: Dict[Any, NDArray] = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._compressor = None

    @property
    def type(self):  # noqa: A003
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @staticmethod
    def _norm_keys_vals(key, value):
        if isinstance(key, (list, tuple)):
            if not isinstance(value, (list, tuple)) or \
                    len(key) != len(value):
                raise MXNetError("key/value list length mismatch")
            return list(key), list(value)
        return [key], [value]

    @staticmethod
    def _merge(vals) -> torch.Tensor:
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        out = vals[0]._data
        for v in vals[1:]:
            out = out + v._data.to(out.device)
        return out

    def init(self, key, value):
        keys, values = self._norm_keys_vals(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = NDArray(v0._data.detach().clone())

    def _reduce_after_compress(self, key, arr):
        """Cross-worker reduction of one key's merged value: identity in
        one process (the dist store sums across the processes)."""
        return arr

    def _reduce_batch_after_compress(self, keys, arrs):
        """The reduction of a whole push batch, called once per push with
        every key's merged value; the dist store makes it one collective
        per dtype."""
        return [self._reduce_after_compress(k, a)
                for k, a in zip(keys, arrs)]

    def _compress(self, key, merged):
        """A key's merged value through the store's 2-bit compressor (the
        reference compresses before the cross-worker reduction)."""
        if self._compressor is None:
            return merged
        return self._compressor.compress(key, merged)

    def push(self, key, value, priority=0):
        keys, values = self._norm_keys_vals(key, value)
        merged_list = self._reduce_batch_after_compress(
            keys, [self._compress(k, self._merge(v))
                   for k, v in zip(keys, values)])
        for k, merged in zip(keys, merged_list):
            if k not in self._store:
                self._store[k] = NDArray(torch.zeros_like(merged))
            if self._updater is not None:
                self._updater(self._str_to_int_key(k), NDArray(merged),
                              self._store[k])
            else:
                self._store[k]._set_data(merged)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._norm_keys_vals(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            val = self._store[k]._data
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                t._set_data(val.to(device=t._data.device,
                                   dtype=t._data.dtype))
        return out

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)
        return out

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)
        return out

    @staticmethod
    def _str_to_int_key(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    def set_updater(self, updater):
        """``updater(key, merged_grad, stored_weight)``, run at push."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store at every push."""
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on every push
        (``{"type": "2bit", "threshold": t}``; gradient_compression.h:52,
        kvstore.py:487)."""
        from .gradient_compression import GradientCompression

        self._compression_params = dict(compression_params)
        self._compressor = GradientCompression(**compression_params)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._optimizer is None:
            raise MXNetError("no optimizer set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._optimizer is None:
            raise MXNetError("no optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        from ..ndarray import waitall

        waitall()

    def __repr__(self):
        return "KVStore(type=%s, keys=%d)" % (self._type, len(self._store))
