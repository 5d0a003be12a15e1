"""Fused kernels, the train step and data parallelism over
``torch.distributed`` (port of ``incubator_mxnet_tpu/parallel``)."""
from . import (checkpoint, collectives, distributed, fault_injection,
               fused_bn, maxpool_idx, mesh, ring_attention, train_step)
from .checkpoint import (CheckpointError, CheckpointManager,
                         CheckpointTopologyError)
from .flash_attention import flash_attention
from .mesh import Mesh, make_mesh
from .train_step import (DynamicLossScale, FunctionalOptimizer, TrainStep,
                         make_train_step)

__all__ = ["checkpoint", "collectives", "distributed", "fault_injection",
           "fused_bn", "maxpool_idx", "mesh", "ring_attention", "train_step",
           "CheckpointError", "CheckpointManager", "CheckpointTopologyError",
           "flash_attention", "DynamicLossScale", "FunctionalOptimizer",
           "Mesh", "TrainStep", "make_mesh", "make_train_step"]
