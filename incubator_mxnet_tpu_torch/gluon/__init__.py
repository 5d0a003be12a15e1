"""Layers, losses and the model zoo as ``nn.Module``s (port of ``incubator_mxnet_tpu/gluon``)."""
from . import loss, model_zoo, nn

__all__ = ["loss", "model_zoo", "nn"]
