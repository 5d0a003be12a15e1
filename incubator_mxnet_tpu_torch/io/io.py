"""Data iterators (port of ``incubator_mxnet_tpu/io/io.py``: ``DataDesc``,
``DataBatch``, ``DataIter`` and its iterator-state protocol,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter`` and
the ``MXDataIter`` placeholder).

Batches are assembled in numpy exactly as the JAX package assembles
them, so both packages give the same batches from the same data and
seeds, and a ``state_dict()`` of one package's iterator (JSON, the same
keys) loads into the other's.  Where the JAX iterators wrap a batch with
``nd.array`` on the default device, the port's take ``ctx=`` as every
factory of the port does: ``None`` is the CUDA card, and a host without
one raises.  On the card a batch goes through pinned host memory and a
``non_blocking`` copy on the consumer's stream (:class:`_HostToDevice`).
"""
from __future__ import annotations

import queue
import threading
import warnings
import weakref
from collections import namedtuple
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import context
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MXDataIter"]


# ---------------------------------------------------------------------------
# iterator-state protocol helpers
# ---------------------------------------------------------------------------

def _rng_state_to_json(state):
    """np.random.RandomState get_state() tuple -> JSON-safe list (the
    state rides the checkpoint manifest, which is JSON)."""
    if state is None:
        return None
    algo, keys, pos, has_gauss, cached = state
    return [str(algo), np.asarray(keys).tolist(), int(pos), int(has_gauss),
            float(cached)]


def _rng_state_from_json(obj):
    if obj is None:
        return None
    algo, keys, pos, has_gauss, cached = obj
    return (str(algo), np.asarray(keys, np.uint32), int(pos),
            int(has_gauss), float(cached))


def _check_state_kind(state, kind):
    got = (state or {}).get("iter")
    if got != kind:
        raise ValueError(
            "iterator state was saved by %r, cannot load into %s — resume "
            "with the same input pipeline the checkpoint was written with"
            % (got, kind))


class _HostToDevice:
    """Hands a batch's numpy arrays over as tensors on ``device``.

    On the CPU each array is wrapped as it is: the iterators make a fresh
    array for every batch.  On the card each goes into a pinned host
    buffer and on to the card by a ``non_blocking`` copy on the current
    stream.  The buffers are recycled through a ring of ``depth`` slots;
    a slot's CUDA event is recorded after its copies, and the slot is
    written again only after that event has completed, so no buffer is
    overwritten while its copy may be in flight."""

    def __init__(self, device, depth=4):
        self.device = device
        self._slots = [None] * int(depth)  # [buffers, start, done] each
        self._next = 0
        self._last = None

    def __call__(self, arrays):
        if self.device.type != "cuda":
            return [torch.from_numpy(a) for a in arrays]
        slot = self._slots[self._next]
        if slot is None:
            slot = self._slots[self._next] = [
                [], torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)]
        else:
            slot[2].synchronize()  # the slot's last copies have finished
        self._next = (self._next + 1) % len(self._slots)
        bufs = slot[0]
        want = [(a.shape, torch.from_numpy(a[:0]).dtype) for a in arrays]
        if [(tuple(b.shape), b.dtype) for b in bufs] != want:
            bufs[:] = [torch.empty(shape, dtype=dtype, pin_memory=True)
                       for shape, dtype in want]
        for b, a in zip(bufs, arrays):
            np.copyto(b.numpy(), a)
        slot[1].record()
        out = [b.to(self.device, non_blocking=True) for b in bufs]
        slot[2].record()
        self._last = slot
        return out

    def last_copy_ms(self):
        """Device time of the last hand-off's copies (waits for them);
        None before the first hand-off to the card."""
        if self._last is None:
            return None
        self._last[2].synchronize()
        return self._last[1].elapsed_time(self._last[2])


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape(+dtype/layout) of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):  # noqa: A003
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError

    # -- iterator-state protocol (mid-epoch checkpoint/resume) ---------
    def state_dict(self) -> Dict[str, Any]:
        """Position/RNG state of this iterator as a JSON-safe dict, so a
        checkpoint can resume the data stream mid-epoch at the exact
        next batch (``TrainStep.save_checkpoint(..., data_iter=)``)."""
        raise NotImplementedError(
            "%s does not implement the iterator-state protocol "
            "(state_dict/load_state_dict); a resumed run would replay "
            "the epoch from batch 0" % type(self).__name__)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore the position saved by :meth:`state_dict`; the next
        ``next()`` yields the batch after the one last consumed."""
        raise NotImplementedError(
            "%s does not implement the iterator-state protocol "
            "(state_dict/load_state_dict)" % type(self).__name__)


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays: dict/list/single data and label,
    shuffle, and ``last_batch_handle`` 'pad'/'discard'/'roll_over'.
    Batches land on ``ctx`` (``None``: the CUDA card)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self._to_device = _HostToDevice(context.resolve(ctx))
        self.data = self._init_data(data, allow_empty=False,
                                    default_name=data_name)
        self.label = self._init_data(label, allow_empty=True,
                                     default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = np.arange(self.num_data)
        self.cursor = -batch_size
        # an instance RNG whose state is part of the iterator-state
        # protocol, so a resumed run shuffles the epochs an
        # uninterrupted run would have
        self._shuffle_rng = np.random.RandomState(
            np.random.randint(0, 2 ** 31)) if shuffle else None
        self._epoch = -1
        self._epoch_rng_state = None  # RNG state at the epoch's start
        self.reset()

    @staticmethod
    def _init_data(data, allow_empty, default_name):
        if data is None:
            if not allow_empty:
                raise ValueError("data cannot be None")
            return []
        if isinstance(data, (np.ndarray, NDArray)):
            data = [data]
        if isinstance(data, (list, tuple)):
            if len(data) == 1:
                data = {default_name: data[0]}
            else:
                data = {("_%d_%s" % (i, default_name)): d
                        for i, d in enumerate(data)}
        out = []
        for k, v in data.items():
            if isinstance(v, NDArray):
                v = v.asnumpy()
            out.append((k, np.asarray(v)))
        return out

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self._epoch += 1
        if self.shuffle:
            # a fresh permutation from the epoch-start RNG state, which
            # is all state_dict carries to re-derive it on resume
            self._epoch_rng_state = self._shuffle_rng.get_state()
            self.idx = np.arange(self.num_data)
            self._shuffle_rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % \
                self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, arr in arrays:
            end = self.cursor + self.batch_size
            if end <= self.num_data:
                part = arr[self.idx[self.cursor:end]]
            else:  # pad wraps around
                pad = end - self.num_data
                part = np.concatenate([arr[self.idx[self.cursor:]],
                                       arr[self.idx[:pad]]], axis=0)
            out.append(np.ascontiguousarray(part))
        return [NDArray(t) for t in self._to_device(out)]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        end = min(self.cursor + self.batch_size, self.num_data)
        return self.idx[self.cursor:end]

    # -- iterator-state protocol ---------------------------------------
    def state_dict(self):
        """Epoch, cursor and the epoch-start shuffle-RNG state: what
        resume needs to re-derive this epoch's permutation and shuffle
        every later epoch identically."""
        st = {"iter": "NDArrayIter", "epoch": self._epoch,
              "shuffle": bool(self.shuffle),
              "cursor": int(self.cursor),
              "num_data": int(self.num_data),
              "batch_size": int(self.batch_size),
              "last_batch_handle": self.last_batch_handle}
        if self.shuffle and self._epoch_rng_state is None:
            # mid-epoch after a restore of the legacy format: the
            # epoch-start state is unknown, so emit the legacy format
            # (explicit permutation + current RNG state) until reset()
            st["idx"] = self.idx.tolist()
            st["rng"] = _rng_state_to_json(self._shuffle_rng.get_state())
        else:
            st["rng0"] = _rng_state_to_json(self._epoch_rng_state)
        return st

    def load_state_dict(self, state):
        _check_state_kind(state, "NDArrayIter")
        # older states lack the flag; an RNG state is present exactly
        # when shuffle was on
        saved_shuffle = bool(state.get(
            "shuffle", state.get("rng") is not None
            or state.get("rng0") is not None))
        if saved_shuffle != bool(self.shuffle):
            raise ValueError(
                "iterator state was saved with shuffle=%s but this "
                "NDArrayIter has shuffle=%s — resume needs the same "
                "shuffle configuration for a bit-identical batch order"
                % (saved_shuffle, self.shuffle))
        for key, have in (("batch_size", int(self.batch_size)),
                          ("last_batch_handle", self.last_batch_handle)):
            saved = state.get(key)
            if saved is not None and saved != have:
                raise ValueError(
                    "iterator state was saved with %s=%r but this "
                    "NDArrayIter has %s=%r — resume needs the same "
                    "batching configuration for a bit-identical batch "
                    "order" % (key, saved, key, have))
        self._epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        if "idx" in state:
            # legacy format: explicit permutation plus the current RNG
            # state
            idx = np.asarray(state["idx"], dtype=self.idx.dtype)
            if idx.shape != self.idx.shape:
                raise ValueError(
                    "iterator state has %d indices, this NDArrayIter "
                    "holds %d samples — resume needs the same dataset"
                    % (idx.size, self.num_data))
            self.idx = idx
            rng = _rng_state_from_json(state.get("rng"))
            if rng is not None:
                if self._shuffle_rng is None:
                    self._shuffle_rng = np.random.RandomState(0)
                self._shuffle_rng.set_state(rng)
            self._epoch_rng_state = None
            return
        if state.get("num_data") is not None \
                and int(state["num_data"]) != self.num_data:
            raise ValueError(
                "iterator state was saved over %d samples, this "
                "NDArrayIter holds %d — resume needs the same dataset"
                % (int(state["num_data"]), self.num_data))
        if self.shuffle:
            # re-derive the epoch's permutation from its start state; the
            # shuffle leaves the RNG where the original run had it
            self._epoch_rng_state = _rng_state_from_json(state["rng0"])
            self._shuffle_rng.set_state(self._epoch_rng_state)
            self.idx = np.arange(self.num_data)
            self._shuffle_rng.shuffle(self.idx)
        else:
            self.idx = np.arange(self.num_data)


class ResizeIter(DataIter):
    """Resize an iterator's epoch to ``size`` batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):  # noqa: A003
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index

    # -- iterator-state protocol ---------------------------------------
    def state_dict(self):
        return {"iter": "ResizeIter", "cur": int(self.cur),
                "inner": self.data_iter.state_dict()}

    def load_state_dict(self, state):
        _check_state_kind(state, "ResizeIter")
        self.cur = int(state["cur"])
        self.current_batch = None
        self.data_iter.load_state_dict(state["inner"])


def _stop_aware_put(q, stop, msg, owner_ref=None) -> bool:
    """Bounded queue put that observes the epoch's stop event and, when
    given, the owner's liveness: a producer stuck on a full queue must
    notice close()/reset(), and one whose owner was dropped (``owner_ref``
    a dead weakref) must exit."""
    while not stop.is_set():
        if owner_ref is not None and owner_ref() is None:
            return False
        try:
            q.put(msg, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _drain_queue(q):
    if q is None:
        return
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def _drain_join_drain(q, stop, thread, join_timeout=5):
    """Worker shutdown: signal stop, drain the queue (a producer blocked
    in its put wakes and sees the flag), join, drain again (it may have
    put one last batch between the first drain and its exit).

    Returns True when the worker exited within ``join_timeout``.  False
    means it is still blocked inside the wrapped iterator's read, and a
    warning says the next epoch cannot be trusted for a bit-identical
    resume: reusing that iterator would advance it concurrently."""
    if stop is not None:
        stop.set()
    _drain_queue(q)
    joined = True
    if thread is not None:
        thread.join(timeout=join_timeout)
        if thread.is_alive():
            joined = False
            warnings.warn(
                "prefetch worker %r did not exit within %gs — it is "
                "still blocked inside the wrapped iterator's read.  "
                "Reusing that iterator (reset()/load_state_dict()) "
                "before the hung read returns may advance its cursor "
                "concurrently; the epoch order is then not "
                "deterministic and mid-epoch resume cannot be trusted"
                % (thread.name, join_timeout), RuntimeWarning,
                stacklevel=3)
    _drain_queue(q)
    return joined


class _CurrentBatchConsumer:
    """The DataIter consumer protocol over one ``current_batch`` slot
    that the subclass's ``_fetch_next()`` fills."""

    current_batch = None

    def next(self):  # noqa: A003
        if not self.iter_next():
            raise StopIteration
        return self.current_batch

    def iter_next(self):
        """Advance to the next batch (the accessors below then read it),
        False at epoch end."""
        try:
            self.current_batch = self._fetch_next()
            return True
        except StopIteration:
            self.current_batch = None
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return getattr(self.current_batch, "pad", 0) or 0

    def getindex(self):
        return getattr(self.current_batch, "index", None)


class PrefetchingIter(_CurrentBatchConsumer, DataIter):
    """Background-thread prefetcher over one iterator.

    The producer thread is joined on exhaustion, :meth:`close` and
    ``__del__``, and an exception raised by the inner iterator is
    forwarded through the queue and re-raised by ``next()``."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise NotImplementedError("multi-iter prefetch: combine upstream")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._prefetch_depth = prefetch_depth
        self._queue: Optional["queue.Queue"] = None
        self._stop: Optional[threading.Event] = None
        self._thread = None
        self.current_batch = None
        self._start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _start(self):
        # the queue and stop event are the epoch's own, captured by the
        # worker: a producer stuck past close()'s join timeout can never
        # deliver into the next epoch
        q = queue.Queue(maxsize=self._prefetch_depth)
        stop = threading.Event()
        inner = self.iter
        wref = weakref.ref(self)

        def worker():
            # no strong reference to the wrapper, so an abandoned
            # PrefetchingIter is collected and its __del__ stops this
            exc = None
            while not stop.is_set():
                try:
                    batch = inner.next()
                except StopIteration:
                    break
                except Exception as e:  # surface in the consumer thread
                    exc = e
                    break
                if not _stop_aware_put(q, stop, batch, wref):
                    return
            if exc is not None:
                _stop_aware_put(q, stop, exc, wref)
            _stop_aware_put(q, stop, None, wref)  # end-of-stream sentinel

        self._queue = q
        self._stop = stop
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _join(self):
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def close(self):
        """Stop and join the producer thread (idempotent)."""
        _drain_join_drain(self._queue, self._stop, self._thread)
        self._thread = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.current_batch = None
        self.iter.reset()
        self._start()

    def _fetch_next(self):
        if self._thread is None and self._queue.empty():
            raise StopIteration  # exhausted/closed; producer already joined
        batch = self._queue.get()
        if batch is None:
            self._join()
            raise StopIteration
        if isinstance(batch, Exception):
            self._join()
            raise batch
        return batch


class CSVIter(DataIter):
    """CSV file iterator (the C++ ``src/io/iter_csv.cc`` equivalent)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, ctx=None, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard", ctx=ctx)
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):  # noqa: A003
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    def state_dict(self):
        return {"iter": "CSVIter", "inner": self._inner.state_dict()}

    def load_state_dict(self, state):
        _check_state_kind(state, "CSVIter")
        self._inner.load_state_dict(state["inner"])


class MXDataIter(DataIter):
    """Placeholder for the reference's C++-registered iterators; the
    record pipeline is :mod:`.record_iter`."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "MXDataIter: use NDArrayIter / recordio-based iterators")
