"""``mx.mod``: the Module API (port of ``incubator_mxnet_tpu/module``):
``Module`` and ``BucketingModule``."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule"]
