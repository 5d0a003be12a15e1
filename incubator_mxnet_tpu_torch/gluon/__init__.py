"""Layers, losses and the model zoo as ``nn.Module``s (port of ``incubator_mxnet_tpu/gluon``)."""
from . import block, loss, model_zoo, nn
from .block import shape_init

__all__ = ["block", "loss", "model_zoo", "nn", "shape_init"]
