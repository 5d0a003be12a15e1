"""``DataLoader`` (port of ``incubator_mxnet_tpu/gluon/data/dataloader.py``):
mini-batches of a ``Dataset`` through a ``BatchSampler``, built by
workers and handed over in order.

The data flow is the reference's: samples are built and batched on the
host, each batch becomes numpy arrays (``_as_host_batch``) and the main
process uploads it to ``device`` once (``_Uploader``).  Every sample is
built under ``context.device_scope("cpu")``, in the main process at
``num_workers=0`` and in each worker thread otherwise, so a dataset or
transform that makes arrays without a device makes them on the host.  On
the card the upload goes through pinned buffers and a ``non_blocking``
copy (``io._HostToDevice``, a ring of 4 slots guarded by CUDA events).

Workers are threads by default (``thread_pool=True``).  With
``thread_pool=False`` they are processes of the ``spawn`` context, as in
the reference; each hides the card from itself
(``CUDA_VISIBLE_DEVICES=""``) before anything in it can reach CUDA, and
reports with every batch whether CUDA was initialized in it
(:meth:`DataLoader.worker_cuda_initialized`).
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np
import torch

from ... import context
from ...io.io import _HostToDevice
from ...ndarray import NDArray
from ...ndarray import ndarray as _nd
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays with ``nd.stack``, tuples
    element by element (a list of batches), anything else with
    ``np.asarray``."""
    if isinstance(data[0], NDArray):
        return _nd.stack(*data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return np.asarray(data)


def _as_host_batch(batch):
    """A batchified tree with its NDArrays as numpy arrays."""
    if isinstance(batch, NDArray):
        return batch.asnumpy()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_as_host_batch(b) for b in batch)
    return batch


def _host_leaves(batch, out):
    if isinstance(batch, np.ndarray):
        out.append(batch)
    elif isinstance(batch, (list, tuple)):
        for b in batch:
            _host_leaves(b, out)


def _rebuild(batch, tensors):
    if isinstance(batch, np.ndarray):
        return NDArray(next(tensors))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_rebuild(b, tensors) for b in batch)
    return batch


class _Uploader:
    """A host batch's numpy arrays as NDArrays on ``device``, in one
    hand-off (one copy an array on the card)."""

    def __init__(self, device):
        self._h2d = _HostToDevice(device)

    def __call__(self, batch):
        leaves = []
        _host_leaves(batch, leaves)
        return _rebuild(batch, iter(self._h2d(leaves)))


def _build(dataset, samples, batchify_fn):
    with context.device_scope("cpu"):
        return _as_host_batch(batchify_fn([dataset[i] for i in samples]))


_worker_dataset = None


def _worker_initializer(dataset):
    """A spawned worker's start: the card hidden from it, the dataset
    kept (shipped once, not with every batch)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    global _worker_dataset
    _worker_dataset = dataset


def _worker_fn(samples, batchify_fn):
    batch = _build(_worker_dataset, samples, batchify_fn)
    return batch, os.getpid(), torch.cuda.is_initialized()


def _thread_worker_fn(samples, batchify_fn, dataset):
    return _build(dataset, samples, batchify_fn)


class _MultiWorkerIter:
    """Batches handed to the workers ``prefetch`` ahead, taken back in
    order through a reorder buffer."""

    def __init__(self, loader):
        self._loader = loader
        self._data_buffer = {}
        self._rcvd_idx = 0
        self._sent_idx = 0
        self._iter = iter(loader._batch_sampler)
        self._upload = _Uploader(loader._device)
        for _ in range(loader._prefetch):
            self._push_next()

    def __len__(self):
        return len(self._loader._batch_sampler)

    def _push_next(self):
        batch = next(self._iter, None)
        if batch is None:
            return
        ld = self._loader
        if ld._thread_pool:
            ret = ld._worker_pool.apply_async(
                _thread_worker_fn, (batch, ld._batchify_fn, ld._dataset))
        else:
            ret = ld._worker_pool.apply_async(
                _worker_fn, (batch, ld._batchify_fn))
        self._data_buffer[self._sent_idx] = ret
        self._sent_idx += 1

    def __next__(self):
        self._push_next()
        if self._rcvd_idx == self._sent_idx:
            assert not self._data_buffer, \
                "data buffer should be empty at this moment"
            raise StopIteration
        ret = self._data_buffer.pop(self._rcvd_idx).get()
        self._rcvd_idx += 1
        if not self._loader._thread_pool:
            ret, pid, cuda = ret
            self._loader._worker_cuda[pid] = cuda
        return self._upload(ret)

    def __iter__(self):
        return self


class DataLoader:
    """Mini-batches of ``dataset`` (the reference's arguments: a
    ``batch_size`` with ``shuffle`` or a ``sampler`` and ``last_batch``,
    or a ``batch_sampler``; ``batchify_fn``, ``num_workers``,
    ``prefetch`` (default ``2 * num_workers``), ``thread_pool``), each
    batch an NDArray tree on ``device`` (None: the enclosing
    ``device_scope``, else the card)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, prefetch=None, thread_pool=True,
                 device=None):
        self._dataset = dataset
        self._thread_pool = thread_pool
        self._worker_pool = None
        self._worker_cuda = {}
        self._device = context.resolve(device)

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")

        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._worker_pool = ThreadPool(self._num_workers)
            else:
                ctx = multiprocessing.get_context("spawn")
                self._worker_pool = ctx.Pool(
                    self._num_workers, initializer=_worker_initializer,
                    initargs=(dataset,))

    def __iter__(self):
        if self._num_workers == 0:
            def _same_process_iter():
                upload = _Uploader(self._device)
                for batch in self._batch_sampler:
                    yield upload(_build(self._dataset, batch,
                                        self._batchify_fn))
            return _same_process_iter()
        return _MultiWorkerIter(self)

    def __len__(self):
        return len(self._batch_sampler)

    def worker_cuda_initialized(self):
        """``{pid: torch.cuda.is_initialized()}`` as each spawned worker
        reported it with its last batch (empty for thread workers)."""
        return dict(self._worker_cuda)

    def __del__(self):
        pool = getattr(self, "_worker_pool", None)
        if pool is not None:
            try:
                pool.terminate()
            except Exception:
                pass
