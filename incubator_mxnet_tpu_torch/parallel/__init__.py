"""Fused kernels and the train step (port of ``incubator_mxnet_tpu/parallel``)."""
from . import fused_bn, maxpool_idx, train_step
from .train_step import (DynamicLossScale, FunctionalOptimizer, TrainStep,
                         make_train_step)

__all__ = ["fused_bn", "maxpool_idx", "train_step", "DynamicLossScale",
           "FunctionalOptimizer", "TrainStep", "make_train_step"]
