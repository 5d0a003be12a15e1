"""Datasets (port of ``incubator_mxnet_tpu/gluon/data/dataset.py``):
``Dataset`` with its lazy combinators (``transform``, ``transform_first``,
``filter``, ``shard``, ``take``, ``sample``), ``SimpleDataset``,
``ArrayDataset`` and ``RecordFileDataset``.

A dataset lives on the host: its samples are numpy values or NDArrays on
the CPU, and a ``DataLoader`` uploads each batch to the card once.
"""
from __future__ import annotations

import os
import threading

from ... import recordio as _recordio

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Base of the datasets: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn(sample)`` is true."""
        return _FilteredDataset(self, fn)

    def shard(self, num_shards, index):
        """Shard ``index`` of ``num_shards`` contiguous shards; the first
        ``len % num_shards`` shards hold one sample more."""
        assert 0 <= index < num_shards
        return _ShardedDataset(self, num_shards, index)

    def take(self, count):
        """The first ``count`` samples."""
        return _TakenDataset(self, count)

    def sample(self, sampler):
        """This dataset in ``sampler``'s index order."""
        return _SampledDataset(self, list(sampler))

    def transform(self, fn, lazy=True):
        """``fn`` over every sample (its elements as arguments when a
        sample is a tuple); computed at once into a ``SimpleDataset``
        when ``lazy`` is false."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` over the first element of every sample only."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    """A picklable closure, so that spawned workers receive the dataset."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _FilteredDataset(Dataset):
    def __init__(self, data, fn):
        self._indices = [i for i in range(len(data)) if fn(data[i])]
        self._data = data

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class _ShardedDataset(Dataset):
    def __init__(self, data, num_shards, index):
        self._data = data
        length = len(data)
        shard_len, rest = divmod(length, num_shards)
        self._start = shard_len * index + min(index, rest)
        self._end = self._start + shard_len + (index < rest)

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        return self._data[self._start + idx]


class _TakenDataset(Dataset):
    def __init__(self, data, count):
        self._data = data
        self._count = min(count, len(data))

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError
        return self._data[idx]


class _SampledDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class SimpleDataset(Dataset):
    """Any sized, indexable object as a dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Equal-length arrays zipped: sample ``i`` is the tuple of their
    ``i``-th elements (the element itself for one array)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; got %d vs %d at " \
                "arg %d" % (len(data), self._length, i)
            if isinstance(data, (list, tuple)):
                data = SimpleDataset(data)
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The raw records of an indexed ``.rec`` file (its ``.idx`` beside
    it), in the index's order.  A read is a seek and a read of one file
    handle, so reads are serialized by a lock: thread workers share the
    dataset."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = _recordio.MXIndexedRecordIO(
            self.idx_file, self.filename, "r")
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        del d["_lock"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
