"""Operators as plain functions on tensors (port of ``incubator_mxnet_tpu/ops``)."""
from . import nn, optimizer_ops

__all__ = ["nn", "optimizer_ops"]
