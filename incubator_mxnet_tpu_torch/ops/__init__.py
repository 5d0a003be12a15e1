"""Operators as plain functions on tensors (port of ``incubator_mxnet_tpu/ops``)."""
from . import contrib, nn, optimizer_ops, rnn

__all__ = ["contrib", "nn", "optimizer_ops", "rnn"]
