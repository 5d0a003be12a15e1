"""Samplers (port of ``incubator_mxnet_tpu/gluon/data/sampler.py``):
``Sampler``, ``SequentialSampler``, ``RandomSampler``, ``SplitSampler``,
``BatchSampler`` and ``FilterSampler``.

The random samplers shuffle with numpy's global generator
(``np.random.shuffle``), as the reference does, so a run seeded with
``np.random.seed`` visits the reference's order.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler",
           "FilterSampler", "BatchSampler", "SplitSampler"]


class Sampler:
    """Base of the index samplers: ``__iter__`` and ``__len__``."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start, start + 1, ..., start + length - 1``."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A permutation of ``range(length)``, drawn anew each pass."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class SplitSampler(Sampler):
    """Part ``part_index`` of ``num_parts`` equal parts of ``range(length)``
    (the remainder dropped), shuffled within the part each pass: one
    worker's shard of a data-parallel job."""

    def __init__(self, length, num_parts=1, part_index=0):
        self.part_len = length // num_parts
        self.start = self.part_len * part_index
        self.end = self.start + self.part_len

    def __iter__(self):
        indices = np.arange(self.start, self.end)
        np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self.part_len


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices from ``sampler``.  A short last
    batch is kept (``"keep"``), dropped (``"discard"``) or carried into
    the next pass (``"rollover"``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of keep/discard/rollover, got %s"
                    % self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(
            "last_batch must be one of keep/discard/rollover, got %s"
            % self._last_batch)


class FilterSampler(Sampler):
    """The indices of ``dataset``'s samples for which ``fn`` is true,
    decided once at construction."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)
