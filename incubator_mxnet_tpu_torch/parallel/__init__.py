"""Fused kernels and the train step (port of ``incubator_mxnet_tpu/parallel``)."""
from . import checkpoint, fused_bn, maxpool_idx, ring_attention, train_step
from .flash_attention import flash_attention
from .train_step import (DynamicLossScale, FunctionalOptimizer, TrainStep,
                         make_train_step)

__all__ = ["checkpoint", "fused_bn", "maxpool_idx", "ring_attention", "train_step",
           "flash_attention", "DynamicLossScale", "FunctionalOptimizer",
           "TrainStep", "make_train_step"]
