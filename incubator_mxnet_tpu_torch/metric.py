"""Evaluation metrics (port of ``incubator_mxnet_tpu/metric.py``): the
registry ``create``, ``EvalMetric`` with local and global counters,
``CompositeEvalMetric`` and every registered metric (``Accuracy``,
``TopKAccuracy``, ``F1``, ``MCC``, ``PCC``, ``Perplexity``, ``MAE``,
``MSE``, ``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``PearsonCorrelation``, ``Loss``, ``Torch``, ``Caffe``, ``CustomMetric``
and ``np``).  Metrics compute on the host in numpy: an NDArray or a
tensor given to ``update`` is copied there.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as _numpy

import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "PCC", "Caffe",
           "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(name, klass):
    _METRIC_REGISTRY[name] = klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    name = metric.lower()
    if name not in _METRIC_REGISTRY:
        raise ValueError("Unknown metric %r" % metric)
    return _METRIC_REGISTRY[name](*args, **kwargs)


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return _numpy.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _update(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


@register
class PCC(EvalMetric):
    """Multiclass Pearson/Matthews correlation from a growing K x K
    confusion matrix (reference metric.py:1528) — the multiclass MCC:
    cov(x,y) / sqrt(cov(x,x) * cov(y,y)) over row/column marginals.
    Local (lcm) and global (gcm) matrices track the base class's
    local/global counter contract."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        self.k = 2
        super().__init__(name, output_names, label_names)

    def reset(self):
        self.lcm = _numpy.zeros((getattr(self, "k", 2),) * 2)
        self.gcm = _numpy.zeros((getattr(self, "k", 2),) * 2)
        self.num_inst = 0
        self.global_num_inst = 0
        self.sum_metric = 0.0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.lcm = _numpy.zeros((self.k,) * 2)
        self.num_inst = 0
        self.sum_metric = 0.0

    def _grow(self, inc):
        self.lcm = _numpy.pad(self.lcm, ((0, inc), (0, inc)))
        self.gcm = _numpy.pad(self.gcm, ((0, inc), (0, inc)))
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        n = cmat.sum()
        x = cmat.sum(axis=1)
        y = cmat.sum(axis=0)
        cov_xx = _numpy.sum(x * (n - x))
        cov_yy = _numpy.sum(y * (n - y))
        if cov_xx == 0 or cov_yy == 0:
            return float("nan")
        i = cmat.diagonal()
        cov_xy = _numpy.sum(i * n - x * y)
        return cov_xy / (cov_xx * cov_yy) ** 0.5

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _numpy.asarray(_as_np(label), _numpy.int32)
            pred = _as_np(pred)
            # shape comparison BEFORE flattening (reference behavior):
            # an (N, 1) pred of class ids must not be argmaxed away
            if pred.shape != label.shape:
                pred = pred.argmax(axis=1)
            label = label.reshape(-1)
            pred = _numpy.asarray(pred, _numpy.int32).reshape(-1)
            hi = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            if hi > self.k:
                self._grow(hi - self.k)
            _numpy.add.at(self.lcm, (pred, label), 1)
            _numpy.add.at(self.gcm, (pred, label), 1)
        # ONE instance per update() call (reference metric.py:1635) —
        # num_inst gates nan-vs-value in get() and feeds composite/
        # speedometer instance counts, which must match the reference
        self.num_inst += 1
        self.global_num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self._calc_mcc(self.lcm))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self._calc_mcc(self.gcm))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, labels, preds):
        for m in self.metrics:
            m.update_dict(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, (NDArray, torch.Tensor, _numpy.ndarray)):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_numpy.int64).reshape(-1)
            label = label.astype(_numpy.int64).reshape(-1)
            correct = (pred == label).sum()
            self._update(float(correct), len(label))


_alias("acc", Accuracy)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__("%s_%d" % (name, top_k), output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype(_numpy.int64)
            topk = _numpy.argsort(-pred, axis=-1)[..., :self.top_k]
            correct = (topk == label.reshape(-1, 1)).any(axis=-1).sum()
            self._update(float(correct), len(label))


_alias("top_k_acc", TopKAccuracy)
_alias("top_k_accuracy", TopKAccuracy)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).reshape(-1).astype(_numpy.int64)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype(_numpy.int64)
            self._tp += float(((pred == 1) & (label == 1)).sum())
            self._fp += float(((pred == 1) & (label == 0)).sum())
            self._fn += float(((pred == 0) & (label == 1)).sum())
            precision = self._tp / max(self._tp + self._fp, 1e-12)
            recall = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * precision * recall / max(precision + recall, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1
            self.global_sum_metric = f1
            self.global_num_inst = 1


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (binary)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self._counts = _numpy.zeros(4)  # tp, fp, fn, tn

    def reset(self):
        super().reset()
        self._counts = _numpy.zeros(4)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).reshape(-1).astype(_numpy.int64)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype(_numpy.int64)
            tp = float(((pred == 1) & (label == 1)).sum())
            fp = float(((pred == 1) & (label == 0)).sum())
            fn = float(((pred == 0) & (label == 1)).sum())
            tn = float(((pred == 0) & (label == 0)).sum())
            self._counts += [tp, fp, fn, tn]
            tp, fp, fn, tn = self._counts
            den = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            mcc = ((tp * tn) - (fp * fn)) / den if den else 0.0
            self.sum_metric = mcc
            self.num_inst = 1
            self.global_sum_metric = mcc
            self.global_num_inst = 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).reshape(-1).astype(_numpy.int64)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_numpy.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(_numpy.log(_numpy.maximum(probs, 1e-10)).sum())
            num += len(label)
        self._update(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            if label.ndim == 1 and pred.ndim != 1:
                label = label.reshape(pred.shape)
            self._update(float(_numpy.abs(label - pred).mean()), 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            if label.ndim == 1 and pred.ndim != 1:
                label = label.reshape(pred.shape)
            self._update(float(((label - pred) ** 2).mean()), 1)


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            if label.ndim == 1 and pred.ndim != 1:
                label = label.reshape(pred.shape)
            self._update(float(_numpy.sqrt(((label - pred) ** 2).mean())), 1)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel().astype(_numpy.int64)
            pred = _as_np(pred)
            prob = pred[_numpy.arange(label.shape[0]), label]
            ce = (-_numpy.log(prob + self.eps)).sum()
            self._update(float(ce), label.shape[0])


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


_alias("nll_loss", NegativeLogLikelihood)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel()
            pred = _as_np(pred).ravel()
            r = _numpy.corrcoef(label, pred)[0, 1]
            self._update(float(r), 1)


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            loss = float(_as_np(pred).sum())
            self._update(loss, int(_numpy.prod(_as_np(pred).shape)))


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Torch):
    """Dummy metric slot for caffe criterion layers (metric.py:1704)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__("custom(%s)" % name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                m, n = reval
                self._update(float(m), n)
            else:
                self._update(float(reval), 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a CustomMetric factory (metric.np parity)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name or getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)


_alias("ce", CrossEntropy)
