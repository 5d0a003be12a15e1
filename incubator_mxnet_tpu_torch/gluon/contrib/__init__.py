"""``mx.gluon.contrib`` (port of ``incubator_mxnet_tpu/gluon/contrib``):
``contrib.nn.MoEFFN``."""
from . import nn

__all__ = ["nn"]
