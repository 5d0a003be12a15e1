"""``Estimator`` (port of
``incubator_mxnet_tpu/gluon/contrib/estimator/estimator.py``): Keras-like
``fit`` and ``evaluate`` over a Gluon net, its loss, metrics and trainer,
with event handlers at the train, epoch and batch boundaries."""
from __future__ import annotations

import copy

from torch.nn.parameter import is_lazy

from .... import context as _context
from .... import metric as metric_mod
from ...trainer import Trainer
from .batch_processor import BatchProcessor
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


def _uninitialized(net):
    """Whether a parameter of ``net`` was never initialized: no
    ``initialize``, no pending initializer of its layer, no data set."""
    for mod in net.modules():
        pending = "_pending_init" in mod.__dict__
        for p in getattr(mod, "_reg_params", {}).values():
            if p._initialized or p._deferred_init is not None:
                continue
            if pending and p._tensor is not None and is_lazy(p._tensor):
                continue
            return True
    return False


class Estimator:
    """``fit``/``evaluate`` over ``net`` with ``loss`` and ``metrics``.

    ``initializer`` re-initializes the whole net; without it a net with
    an uninitialized parameter gets ``net.initialize()``.  ``trainer``
    defaults to ``Trainer(net.collect_params(), "adam", {"learning_rate":
    1e-3})``.  ``context`` (the reference's name) is the device the
    batches arrive on: None is the enclosing ``device_scope``, else the
    card."""

    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None, batch_processor=None):
        self.net = net
        self.loss = loss
        if metrics is None:
            self.train_metrics = []
        else:
            self.train_metrics = list(metrics) \
                if isinstance(metrics, (list, tuple)) else [metrics]
        self.context = _context.resolve(context)
        self.stop_training = False
        self.resumed_epoch = 0
        self.batch_processor = batch_processor or BatchProcessor()

        if initializer is not None:
            self.net.initialize(init=initializer, force_reinit=True)
        elif _uninitialized(self.net):
            self.net.initialize()
        if trainer is None:
            trainer = Trainer(self.net.collect_params(), "adam",
                              {"learning_rate": 1e-3})
        self.trainer = trainer
        self.train_loss_metric = metric_mod.Loss(name="train loss")
        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]

    def evaluate(self, val_data, batch_axis=0):
        """The validation metrics over ``val_data`` (a ``Loss`` metric is
        fed the losses, the others labels and predictions):
        ``{name: value}``."""
        for metric in self.val_metrics:
            metric.reset()
        for batch in val_data:
            _, labels, preds, losses = self.batch_processor.evaluate_batch(
                self, batch, batch_axis=batch_axis)
            for metric in self.val_metrics:
                if isinstance(metric, metric_mod.Loss):
                    metric.update(0, losses)
                else:
                    metric.update(labels, preds)
        return {m.get()[0]: m.get()[1] for m in self.val_metrics}

    def fit(self, train_data, val_data=None, epochs=None,
            event_handlers=None, batches=None, batch_axis=0):
        """Train for ``epochs`` epochs or ``batches`` batches (one epoch
        when neither is given), the handlers called at each boundary;
        the trainer steps by the batch size along ``batch_axis``."""
        self.stop_training = False
        if epochs is None and batches is None:
            epochs = 1
        handlers = self._prepare_handlers(val_data, event_handlers,
                                          epochs, batches)
        train_begin = [h for h in handlers if isinstance(h, TrainBegin)]
        epoch_begin = [h for h in handlers if isinstance(h, EpochBegin)]
        batch_begin = [h for h in handlers if isinstance(h, BatchBegin)]
        batch_end = [h for h in handlers if isinstance(h, BatchEnd)]
        epoch_end = [h for h in handlers if isinstance(h, EpochEnd)]
        train_end = [h for h in handlers if isinstance(h, TrainEnd)]

        for h in train_begin:
            h.train_begin(self)
        while not self.stop_training:
            for h in epoch_begin:
                h.epoch_begin(self)
            self.train_loss_metric.reset()
            for batch in train_data:
                if self.stop_training:
                    break
                for h in batch_begin:
                    h.batch_begin(self, batch=batch)
                data, labels, preds, losses = \
                    self.batch_processor.fit_batch(self, batch,
                                                   batch_axis=batch_axis)
                first = data[0] if isinstance(data, (list, tuple)) \
                    else data
                self.trainer.step(first.shape[batch_axis])
                self.train_loss_metric.update(0, losses)
                for h in batch_end:
                    h.batch_end(self, batch=batch, pred=preds,
                                label=labels, loss=losses)
            for h in epoch_end:
                h.epoch_end(self)
        for h in train_end:
            h.train_end(self)
        return self

    def _prepare_handlers(self, val_data, event_handlers, epochs, batches):
        """The given handlers, plus the defaults that none of them
        replaces (stopping, metrics, validation, logging), sorted by
        ``priority``."""
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=list(self.train_metrics) + [self.train_loss_metric]))
        handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return handlers
