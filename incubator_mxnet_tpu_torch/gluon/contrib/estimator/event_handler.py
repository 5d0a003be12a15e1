"""The Estimator's event handlers (port of
``incubator_mxnet_tpu/gluon/contrib/estimator/event_handler.py``): the six
event mixins, ``StoppingHandler``, ``MetricHandler``,
``ValidationHandler``, ``LoggingHandler``, ``CheckpointHandler`` and
``EarlyStoppingHandler``.  ``Estimator.fit`` calls the handlers of each
event in ``priority`` order (absent: 0).  A checkpoint is
``<prefix>-epoch<N>.params`` (``save_parameters``, the reference's
format) beside ``<prefix>-epoch<N>.states`` (``Trainer.save_states``)."""
from __future__ import annotations

import logging
import os
import time
import warnings

import numpy as np

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop at max_epoch/max_batch."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch == self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch == self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset + update train metrics."""

    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []
        self.priority = -np.inf

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        for metric in self.train_metrics:
            if getattr(metric, "name", "") and "loss" in metric.name:
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every ``epoch_period`` epochs."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log training progress."""

    LOG_PER_EPOCH = 1
    LOG_PER_BATCH = 2

    def __init__(self, log_interval="epoch", metrics=None, priority=np.inf):
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.log_interval = log_interval
        self.priority = priority
        self.logger = logging.getLogger("estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()

    def train_end(self, estimator, *args, **kwargs):
        train_time = time.time() - self.train_start
        msg = "Train finished using total %ds with %d epochs. " \
            % (train_time, self.current_epoch)
        for metric in self.metrics:
            name, value = metric.get()
            msg += "%s: %.4f, " % (name, value)
        self.logger.info(msg.rstrip(", "))

    def batch_end(self, estimator, *args, **kwargs):
        if self.log_interval == "batch" or \
                self.log_interval == self.LOG_PER_BATCH:
            msg = "[Epoch %d][Batch %d] " % (self.current_epoch,
                                             self.batch_index)
            for metric in self.metrics:
                name, value = metric.get()
                msg += "%s: %.4f, " % (name, value)
            self.logger.info(msg.rstrip(", "))
        self.batch_index += 1

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        epoch_time = time.time() - self.epoch_start
        msg = "[Epoch %d] finished in %.3fs: " % (self.current_epoch,
                                                  epoch_time)
        for metric in self.metrics:
            name, value = metric.get()
            msg += "%s: %.4f, " % (name, value)
        self.logger.info(msg.rstrip(", "))
        self.current_epoch += 1
        self.batch_index = 0


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save model (+trainer states) periodically; supports max_checkpoints,
    save_best via a monitored metric, and resume."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.verbose = verbose
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.saved_checkpoints = []
        self.current_epoch = 0
        self.current_batch = 0
        self.trained_epoch = -1
        if save_best and monitor is None:
            raise ValueError("save_best requires a monitor metric")
        if mode == "min" or (mode == "auto" and monitor is not None
                             and "loss" in getattr(monitor, "name", "")):
            self.monitor_op = np.less
            self.best = np.inf
        else:
            self.monitor_op = np.greater
            self.best = -np.inf

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        if self.resume_from_checkpoint:
            self._resume(estimator)

    def _ckpt_path(self, epoch):
        return os.path.join(self.model_dir, "%s-epoch%d.params"
                            % (self.model_prefix, epoch))

    def _states_path(self, epoch):
        return os.path.join(self.model_dir, "%s-epoch%d.states"
                            % (self.model_prefix, epoch))

    def _resume(self, estimator):
        import re
        best_epoch = -1
        if not os.path.isdir(self.model_dir):
            return
        for f in os.listdir(self.model_dir):
            m = re.match(r"%s-epoch(\d+)\.params" % re.escape(
                self.model_prefix), f)
            if m:
                best_epoch = max(best_epoch, int(m.group(1)))
        if best_epoch >= 0:
            estimator.net.load_parameters(self._ckpt_path(best_epoch))
            states = self._states_path(best_epoch)
            if estimator.trainer is not None and os.path.exists(states):
                estimator.trainer.load_states(states)
            self.trained_epoch = best_epoch
            self.current_epoch = best_epoch + 1
            estimator.resumed_epoch = self.current_epoch

    def epoch_end(self, estimator, *args, **kwargs):
        if self.epoch_period and \
                (self.current_epoch + 1) % self.epoch_period == 0:
            self._save(estimator)
        self.current_epoch += 1

    def _save(self, estimator):
        do_save = True
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            do_save = bool(self.monitor_op(value, self.best))
            if do_save:
                self.best = value
        if not do_save:
            return
        path = self._ckpt_path(self.current_epoch)
        estimator.net.save_parameters(path)
        if estimator.trainer is not None:
            estimator.trainer.save_states(self._states_path(
                self.current_epoch))
        self.saved_checkpoints.append(self.current_epoch)
        while len(self.saved_checkpoints) > self.max_checkpoints:
            old = self.saved_checkpoints.pop(0)
            for p in (self._ckpt_path(old), self._states_path(old)):
                if os.path.exists(p):
                    os.remove(p)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if mode == "min" or (mode == "auto"
                             and "loss" in getattr(monitor, "name", "")):
            self.monitor_op = np.less
        else:
            self.monitor_op = np.greater
        if self.monitor_op == np.greater:  # pylint: disable=comparison-with-callable
            self.min_delta *= 1
        else:
            self.min_delta *= -1

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        if self.baseline is not None:
            self.best = self.baseline
        else:
            self.best = np.inf if self.monitor_op == np.less else -np.inf  # pylint: disable=comparison-with-callable

    def epoch_end(self, estimator, *args, **kwargs):
        _, current = self.monitor.get()
        if current is None or np.isnan(current):
            warnings.warn("early stopping monitor returned nan")
            self.current_epoch += 1
            return
        if self.monitor_op(current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            logging.getLogger("estimator").info(
                "Epoch %d: early stopping due to %s not improving",
                self.stopped_epoch, getattr(self.monitor, "name", "metric"))
