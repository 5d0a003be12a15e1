"""``mx.gluon.contrib.data`` (port of
``incubator_mxnet_tpu/gluon/contrib/data/__init__.py``):
``IntervalSampler``."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """``0, interval, 2 * interval, ..., 1, interval + 1, ...``: the
    strided order of truncated-BPTT batching; without ``rollover`` only
    the pass from 0."""

    def __init__(self, length, interval, rollover=True):
        self._length = int(length)
        self._interval = int(interval)
        self._rollover = bool(rollover)

    def __iter__(self):
        for start in range(self._interval if self._rollover else 1):
            for i in range(start, self._length, self._interval):
                yield i

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
