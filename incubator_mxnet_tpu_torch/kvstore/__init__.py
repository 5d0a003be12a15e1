"""``mx.kv``: the KVStore in one process (port of
``incubator_mxnet_tpu/kvstore``)."""
from .kvstore import KVStore, KVStoreBase, create

__all__ = ["KVStore", "KVStoreBase", "create"]
