"""Fused kernels, the train step, and data, sequence, pipeline, tensor
and expert parallelism over ``torch.distributed`` (port of
``incubator_mxnet_tpu/parallel``)."""
from . import (checkpoint, collectives, distributed, fault_injection,
               fused_bn, maxpool_idx, mesh, moe, pipeline, ring_attention,
               train_step)
from .checkpoint import (CheckpointError, CheckpointManager,
                         CheckpointTopologyError)
from .flash_attention import flash_attention
from .mesh import Mesh, P, make_mesh
from .moe import load_balancing_loss, moe_ffn, moe_ffn_sharded
from .pipeline import pipeline_apply, spmd_pipeline, stack_stage_params
from .train_step import (DynamicLossScale, FunctionalOptimizer, TrainStep,
                         make_train_step)

__all__ = ["checkpoint", "collectives", "distributed", "fault_injection",
           "fused_bn", "maxpool_idx", "mesh", "moe", "pipeline",
           "ring_attention", "train_step", "CheckpointError",
           "CheckpointManager", "CheckpointTopologyError",
           "flash_attention", "DynamicLossScale", "FunctionalOptimizer",
           "Mesh", "P", "TrainStep", "make_mesh", "make_train_step",
           "load_balancing_loss", "moe_ffn", "moe_ffn_sharded",
           "pipeline_apply", "spmd_pipeline", "stack_stage_params"]
