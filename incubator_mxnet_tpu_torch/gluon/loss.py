"""Losses (port of ``incubator_mxnet_tpu/gluon/loss.py``): the ``Loss``
base (``weight``, ``batch_axis``, ``sample_weight``) and its 13 losses,
as ``HybridBlock``s on tensors (called on NDArrays, they return
NDArrays recorded on the port's autograd).

Every loss but ``TripletLoss``, ``CTCLoss``, ``PoissonNLLLoss`` and
``CosineEmbeddingLoss`` ends, as in the reference, with the mean over
every axis but ``batch_axis``: one value per sample.

``SoftmaxCrossEntropyLoss`` and ``KLDivLoss`` compose on symbols: their
``hybrid_forward`` is the reference's (its ops, attributes and input
order).  The other losses raise there, as the reference's do (their
bodies read the symbol's shape, which a symbol lacks).  ``CTCLoss`` is
``torch.nn.functional.ctc_loss`` (the reference computes it outside
Pallas) with the reference's layouts and label convention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """``loss * sample_weight`` (broadcast) ``* weight``."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(x, y):
    return x.reshape(y.shape)


def _weighted_sym(F, loss, weight=None, sample_weight=None):  # noqa: N803
    """The reference's ``_apply_weighting`` on symbols."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_exclude(loss, batch_axis):
    """The mean over every axis but ``batch_axis``."""
    keep = batch_axis % loss.dim() if loss.dim() else None
    axes = [a for a in range(loss.dim()) if a != keep]
    return loss.mean(dim=axes) if axes else loss


def _softrelu(x):
    return tF.softplus(x)


class Loss(HybridBlock):
    """Base of the losses: ``weight`` scales the loss, ``batch_axis`` is
    the axis that the per-sample mean keeps."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis=%s, w=%s" % (self._batch_axis, self._weight)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(_reshape_like(label, pred) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_reshape_like(label, pred) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-torch.abs(pred)) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over ``axis``.  Sparse labels (class
    indices) are picked in MXNet's clip mode: an out-of-range index clips
    to the nearest class; dense labels (``sparse_label=False``) are
    probabilities of ``pred``'s shape.  ``from_logits`` takes ``pred`` as
    log-probabilities.  One value per sample: the mean over every axis
    but ``batch_axis``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis % pred.dim()
        if not self._from_logits:
            pred = tF.log_softmax(pred, dim=axis)
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[axis] - 1)
            loss = -torch.gather(pred, axis, idx.unsqueeze(axis))
        else:
            label = _reshape_like(label, pred)
            loss = -(pred * label).sum(dim=axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)

    def hybrid_forward(self, F, pred, label, sample_weight=None):  # noqa: N803
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _weighted_sym(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = tF.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)

    def hybrid_forward(self, F, pred, label, sample_weight=None):  # noqa: N803
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _weighted_sym(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist temporal classification loss, one value per
    sequence.  ``layout`` is ``"NTC"`` or ``"TNC"``, ``label_layout``
    ``"NT"`` or ``"TN"``.  The reference's convention (its
    ``blank_label="last"``): label ``l`` scores class ``l + 1`` and class
    0 is the blank; a label below 0 pads, unless ``label_lengths`` is
    given."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        t, n, _ = pred.shape
        labels = label.long() + 1
        if label_lengths is None:
            label_lengths = (labels > 0).sum(dim=1)
        label_lengths = label_lengths.long()
        if pred_lengths is None:
            pred_lengths = torch.full((n,), t, dtype=torch.long,
                                      device=pred.device)
        logp = tF.log_softmax(pred.float(), dim=-1)
        loss = tF.ctc_loss(logp, labels.clamp_min(0), pred_lengths.long(),
                           label_lengths, blank=0, reduction="none")
        return _apply_weighting(loss.to(pred.dtype), self._weight,
                                sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_reshape_like(label, pred) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _reshape_like(label, pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * _reshape_like(label, pred)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label \
            + _softrelu(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(positive, pred)
        negative = _reshape_like(negative, pred)
        diff = torch.square(positive - pred) - torch.square(negative - pred)
        keep = self._batch_axis % diff.dim()
        axes = [a for a in range(diff.dim()) if a != keep]
        loss = torch.relu((diff.sum(dim=axes) if axes else diff)
                          + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = _reshape_like(label, pred)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = label * torch.log(label + 1e-12) - label \
                + 0.5 * torch.log(2 * 3.1415926535 * (label + 1e-12))
            stirling = torch.where(label <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(input1, input2)
        cos = (input1 * input2).sum(dim=-1) / (
            torch.linalg.vector_norm(input1, dim=-1)
            * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)

