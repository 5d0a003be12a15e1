"""``mx.kv``: the KVStore (port of ``incubator_mxnet_tpu/kvstore``), in
one process and across processes over ``torch.distributed``."""
from .dist import DistKVStore, init_process_group, is_initialized
from .kvstore import KVStore, KVStoreBase, create

__all__ = ["KVStore", "KVStoreBase", "DistKVStore", "create",
           "init_process_group", "is_initialized"]
