"""``mx.mod``: the Module API (port of ``incubator_mxnet_tpu/module``).
``BucketingModule`` waits for ROADMAP A16."""
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module"]
