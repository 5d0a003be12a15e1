"""``BatchProcessor`` (port of
``incubator_mxnet_tpu/gluon/contrib/estimator/batch_processor.py``): the
work on one batch that ``Estimator.fit`` and ``evaluate`` call, to be
overridden for several losses or a gradient flow of one's own.  A batch
is the ``DataLoader``'s ``[data, label]`` (or a ``DataBatch``), already
on the device."""
from __future__ import annotations

from .... import autograd

__all__ = ["BatchProcessor"]


class BatchProcessor:
    """``fit_batch`` and ``evaluate_batch`` of the plain loop."""

    @staticmethod
    def _get_data_and_label(batch):
        if isinstance(batch, (list, tuple)):
            return batch[0], batch[1]
        return batch.data[0], batch.label[0]

    def evaluate_batch(self, estimator, val_batch, batch_axis=0):
        """``(data, [label], [pred], [loss])`` of one validation batch."""
        data, label = self._get_data_and_label(val_batch)
        pred = estimator.net(data)
        loss = estimator.loss(pred, label)
        return data, [label], [pred], [loss]

    def fit_batch(self, estimator, train_batch, batch_axis=0):
        """Forward and backward of one training batch (the estimator
        steps the trainer): ``(data, [label], [pred], [loss])``."""
        data, label = self._get_data_and_label(train_batch)
        with autograd.record():
            pred = estimator.net(data)
            loss = estimator.loss(pred, label)
        loss.backward()
        return data, [label], [pred], [loss]
