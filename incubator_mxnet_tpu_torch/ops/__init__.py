"""Operators as plain functions on tensors (port of ``incubator_mxnet_tpu/ops``)."""
from . import (contrib, control_flow, linalg, nn, optimizer_ops, quantization,
               rnn)

__all__ = ["contrib", "control_flow", "linalg", "nn", "optimizer_ops",
           "quantization", "rnn"]
