"""Operators as plain functions on tensors (port of ``incubator_mxnet_tpu/ops``).

Importing this package registers every op in the reference's order:
``contrib_tail`` and ``parity_tail`` after the samplers, and ``npi``
last, because its aliases resolve against what is registered then.
"""
from . import (contrib, control_flow, linalg, math, nn, optimizer_ops,
               quantization, rnn, tensor)
from .. import random  # noqa: F401  (the samplers)
from . import contrib_tail, parity_tail  # noqa: E402
from . import npi  # noqa: E402  (the _npi_*/_np_*/_npx_* names)

__all__ = ["contrib", "contrib_tail", "control_flow", "linalg", "math", "nn",
           "npi", "optimizer_ops", "parity_tail", "quantization", "rnn",
           "tensor"]
