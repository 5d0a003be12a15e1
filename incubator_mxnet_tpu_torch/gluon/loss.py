"""Losses of the train path (port of ``incubator_mxnet_tpu/gluon/loss.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SoftmaxCrossEntropyLoss"]


class SoftmaxCrossEntropyLoss(nn.Module):
    """Softmax cross-entropy over the last axis with sparse labels (class
    indices), one value per sample.  Labels are picked in MXNet's
    ``pick`` clip mode: an out-of-range index clips to the nearest class.
    Dense labels, ``from_logits`` and weights wait for a later slice."""

    def forward(self, pred, label):
        logp = F.log_softmax(pred, dim=-1)
        idx = label.long().clamp(0, pred.shape[-1] - 1)
        return -torch.gather(logp, -1, idx.unsqueeze(-1)).squeeze(-1)
