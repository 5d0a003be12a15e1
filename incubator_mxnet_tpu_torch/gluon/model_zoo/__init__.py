"""Model zoo (port of ``incubator_mxnet_tpu/gluon/model_zoo``)."""
from . import vision

__all__ = ["vision"]
