"""Image record iterators (port of ``incubator_mxnet_tpu/io/record_iter.py``:
``ImageRecordIter``, ``ImageRecordUInt8Iter``, their producer thread and
helpers).

A producer thread drives a ``ThreadPoolExecutor`` whose workers decode
and augment records in numpy (and PIL for ``resize``), assembles whole
batches and queues up to ``prefetch_buffer`` of them.  The decode, the
per-record ``RandomState`` seeds, the shuffle, the ``round_batch`` wrap
and the ``part_index``/``num_parts`` sharding are the JAX package's
code, so both packages give bit-identical batches, and their
``state_dict()`` (the consumer's position and the epoch-start RNG state)
load into each other.  The consumer's ``next()`` hands the batch to
``ctx`` (``None``: the CUDA card) through pinned memory
(``io._HostToDevice``).

``ImageDetRecordIter`` is ``ImageRecordIter`` over detection records:
variable-length labels padded with -1 to one width, scanned from the
record headers alone when no width is given.  ``MNISTIter`` reads idx
files (the MNIST container) into an ``NDArrayIter``.  ``LibSVMIter`` is
not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import context
from ..base import MXNetError
from ..ndarray import NDArray
from ..recordio import (MXIndexedRecordIO, MXRecordIO, _corrupt_record_error,
                        _kMagic, _torn_final_record, unpack_img)
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter, _HostToDevice,
                 _check_state_kind, _rng_state_from_json,
                 _rng_state_to_json)

__all__ = ["ImageRecordIter", "ImageRecordUInt8Iter", "ImageDetRecordIter",
           "MNISTIter"]

#: preprocess threads when neither the caller nor the environment says
_DEFAULT_THREADS = 4


class _Prefetcher:
    """Bounded-queue producer thread.  Each epoch gets its own queue and
    stop event, so a producer that outlives ``stop()``'s join timeout can
    never leak batches (or its end-of-epoch sentinel) into the next
    epoch's queue."""

    def __init__(self, make_epoch_iter, depth):
        self._make = make_epoch_iter
        self._depth = max(1, int(depth))
        self._q = None
        self._thread = None
        self._stop_event = None

    def start(self):
        self.stop()
        q = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def run():
            try:
                for item in self._make():
                    if stop.is_set():
                        return
                    q.put(item)
            except Exception as e:  # surface in consumer
                q.put(e)
            finally:
                if not stop.is_set():
                    q.put(None)  # end-of-epoch sentinel

        self._q = q
        self._stop_event = stop
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def next(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        if self._thread is not None:
            self._stop_event.set()
            try:  # drain so the producer can observe the stop flag
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None


class ImageRecordIter(DataIter):
    """Threaded image record iterator.

    Parameters mirror the reference iterator: ``path_imgrec``,
    ``path_imgidx`` (optional; enables shuffle/sharding by record),
    ``data_shape`` (C,H,W), ``batch_size``, ``shuffle``, ``rand_crop``,
    ``rand_mirror``, ``resize`` (shorter side), ``mean_r/g/b``,
    ``std_r/g/b``, ``preprocess_threads`` (default
    ``$MXNET_CPU_WORKER_NTHREADS`` or 4), ``prefetch_buffer``,
    ``part_index``/``num_parts``, ``label_width``, ``round_batch``;
    ``ctx`` is where batches land (``None``: the CUDA card).
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, resize=-1, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 preprocess_threads=None, prefetch_buffer=4, part_index=0,
                 num_parts=1, label_width=1, round_batch=True, seed=0,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 ctx=None, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self._to_device = _HostToDevice(context.resolve(ctx))
        self._path_rec = path_imgrec
        self._path_idx = path_imgidx
        self._part_index, self._num_parts = int(part_index), int(num_parts)
        self.data_shape = tuple(int(s) for s in data_shape)
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self.label_width = int(label_width)
        self.round_batch = round_batch
        self.dtype = np.dtype(dtype)
        self._rng = np.random.RandomState(seed + part_index)
        if preprocess_threads is None:
            try:
                preprocess_threads = int(os.environ.get(
                    "MXNET_CPU_WORKER_NTHREADS", _DEFAULT_THREADS))
            except ValueError:
                preprocess_threads = _DEFAULT_THREADS
        self._pool = ThreadPoolExecutor(max_workers=int(preprocess_threads))
        self.data_name, self.label_name = data_name, label_name

        if path_imgidx and os.path.exists(path_imgidx):
            self._rec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._payloads = None
            self._keys = list(self._rec.keys)
        else:
            # no index: scan once and keep the payloads in order
            self._rec = None
            rec = MXRecordIO(path_imgrec, "r")
            payloads = []
            while True:
                s = rec.read()
                if s is None:
                    break
                payloads.append(s)
            rec.close()
            self._payloads = payloads
            self._keys = list(range(len(payloads)))
        # shard across data-parallel workers, round-robin
        self._keys = self._keys[part_index::num_parts]
        if not self._keys:
            raise MXNetError("no records in %s (part %d/%d)"
                             % (path_imgrec, part_index, num_parts))
        self._lock = threading.Lock()  # indexed reads seek a shared handle
        self._prefetcher = _Prefetcher(self._epoch, prefetch_buffer)
        self._current = None
        self._epoch_num = -1
        self._resume_consumed = 0
        self._epoch_rng_state = None
        self.reset()

    # -- decode + augment: resize shorter side, crop, mirror; normalize
    #    per batch in _epoch ----------------------------------------------
    def _read_payload(self, key):
        if self._payloads is not None:
            return self._payloads[key]
        with self._lock:
            return self._rec.read_idx(key)

    def _decode_one(self, key, eidx, aug_seed):
        # a RandomState per record: worker threads share no RNG state,
        # and a (seed, epoch, record) triple always augments alike
        rng = np.random.RandomState((aug_seed + eidx) & 0x7FFFFFFF)
        s = self._read_payload(key)
        header, img = unpack_img(s, iscolor=1)
        c, h, w = self.data_shape
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if self.resize > 0:
            img = _resize_shorter(img, self.resize)
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = _resize_shorter(img, max(h, w))
            ih, iw = img.shape[:2]
        if self.rand_crop:
            y0 = rng.randint(0, ih - h + 1)
            x0 = rng.randint(0, iw - w + 1)
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        img = img[y0:y0 + h, x0:x0 + w]
        if self.rand_mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        return eidx, np.ascontiguousarray(img[..., :c]), \
            self._label_of(header)

    #: what pads a label row shorter than ``label_width``, and whether a
    #: longer one raises (``ImageDetRecordIter``) or is cut
    label_pad_value = 0.0
    _label_overflow_fatal = False

    def _label_of(self, header):
        """A fixed-width label row, padded with ``label_pad_value``."""
        label = np.asarray(header.label, np.float32).reshape(-1)
        if label.size < self.label_width:
            label = np.pad(label, (0, self.label_width - label.size),
                           constant_values=self.label_pad_value)
        elif label.size > self.label_width and self._label_overflow_fatal:
            raise MXNetError(
                "label_pad_width %d smaller than this record's label "
                "width %d: objects would be dropped "
                "(iter_image_det_recordio.cc:334 raises here too)"
                % (self.label_width, label.size))
        return label[: self.label_width]

    def _epoch(self):
        # mid-epoch resume: the batches before the resume point are
        # fast-forwarded — every producer-RNG draw still happens (the
        # shuffle order and per-batch aug seeds match the uninterrupted
        # run) but no record is read or decoded
        skip = self._resume_skip
        self._resume_skip = 0
        order = list(self._keys)
        if self.shuffle:
            self._rng.shuffle(order)
        n = len(order)
        bs = self.batch_size
        c, h, w = self.data_shape
        for bidx, start in enumerate(range(0, n, bs)):
            chunk = order[start:start + bs]
            pad = 0
            if len(chunk) < bs:
                if not self.round_batch:
                    break
                pad = bs - len(chunk)
                while len(chunk) < bs:  # wrap repeatedly: shard may be tiny
                    chunk = chunk + order[: bs - len(chunk)]
            aug_seed = int(self._rng.randint(0, 2**31))  # producer thread only
            if bidx < skip:
                continue
            # uint8 staging only on the raw-bytes path, so float payloads
            # never wrap mod 256
            raw_bytes = getattr(self, "_raw_bytes", False)
            stage = np.empty((bs, h, w, c),
                             np.uint8 if raw_bytes else self.dtype)
            label = np.empty((bs, self.label_width), np.float32)
            futs = [self._pool.submit(self._decode_one, k, i, aug_seed)
                    for i, k in enumerate(chunk)]
            err = None
            for k0, f in zip(chunk, futs):
                try:
                    i, d, l = f.result()
                except Exception as e:  # undecodable record
                    if err is None:
                        err = e
                        err._mxtpu_batch_error = True  # read by iter_next
                        err.path = self._path_rec
                        if self._rec is not None:
                            err.offset = self._rec.idx.get(k0)
                    continue  # drain the rest of the pool's futures
                stage[i] = d
                label[i] = l
            if err is not None:
                # yield, not raise: raising would end the epoch's
                # generator; the consumer decides what a bad batch costs
                yield err
                continue
            if raw_bytes:
                data = np.ascontiguousarray(stage.transpose(0, 3, 1, 2))
            else:
                # normalize once per batch, mean/std cut to C channels
                data = ((stage.astype(np.float32) - self.mean[:c]) /
                        self.std[:c]).transpose(0, 3, 1, 2).astype(
                            self.dtype, copy=False)
                data = np.ascontiguousarray(data)
            yield (data, label, pad)

    # -- DataIter interface ------------------------------------------------
    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) + self.data_shape,
                         self.dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape, np.float32)]

    def reset(self):
        # stop the old epoch's producer before touching the RNG it draws
        # from, then leave the RNG where the old epoch's draws for the
        # batches the consumer took, and the one the producer had begun
        # beyond them, end; however far the producer had read ahead, the
        # next epoch does not depend on its timing (ROADMAP Queue C: the
        # reference's reset depends on it)
        self._prefetcher.stop()
        if self._epoch_rng_state is not None:
            self._rng.set_state(self._after_batches(
                self._epoch_rng_state, self._consumed + 1))
        self._start_epoch()

    def _after_batches(self, state, batches):
        """The producer RNG's state after an epoch's shuffle and the
        augmentation seeds of its first ``batches`` batches (at most its
        own), drawn from ``state`` as :meth:`_epoch` draws them."""
        rng = np.random.RandomState()
        rng.set_state(state)
        order = list(self._keys)
        if self.shuffle:
            rng.shuffle(order)
        n, bs = len(order), self.batch_size
        for bidx, start in enumerate(range(0, n, bs)):
            if bidx >= batches or (n - start < bs and not self.round_batch):
                break
            rng.randint(0, 2**31)
        return rng.get_state()

    def _start_epoch(self):
        # snapshot the epoch-start state (the checkpointable shuffle
        # state: the live RNG races ahead of consumption) and start
        skip = self._resume_consumed
        self._resume_consumed = 0
        self._epoch_rng_state = self._rng.get_state()
        self._epoch_num += 1
        self._consumed = skip
        self._resume_skip = skip  # read once by _epoch in the producer
        self._prefetcher.start()
        self._current = None

    def next(self):  # noqa: A003
        if not self.iter_next():
            raise StopIteration
        batch, self._current = self._current, None
        return batch

    def iter_next(self):
        """Advance and stage the next batch for getdata/getlabel/getpad."""
        try:
            item = self._prefetcher.next()
        except Exception as e:
            if getattr(e, "_mxtpu_batch_error", False):
                # a per-batch decode error consumes its batch slot
                self._consumed += 1
                self._current = None
            raise
        if item is None:
            self._current = None
            return False
        self._consumed += 1
        data, label, pad = item
        if self.label_width == 1:
            label = np.ascontiguousarray(label[:, 0])
        data, label = self._to_device([data, label])
        self._current = DataBatch(
            data=[NDArray(data)], label=[NDArray(label)], pad=pad,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        return True

    def h2d_ms(self):
        """Device time of the last batch's host-to-card copies (None on
        the CPU)."""
        return self._to_device.last_copy_ms()

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad if self._current is not None else 0

    def getindex(self):
        return None

    # -- iterator-state protocol ---------------------------------------
    def state_dict(self):
        """The consumer's position: epoch, batch slots consumed (the
        producer's read-ahead is not counted: it is produced again on
        resume) and the epoch-start RNG state that regenerates this
        epoch's order and augmentation seeds."""
        return {"iter": type(self).__name__, "epoch": self._epoch_num,
                "batch": int(self._consumed),
                "shuffle": bool(self.shuffle),
                "batch_size": int(self.batch_size),
                "num_records": len(self._keys),
                "part_index": self._part_index,
                "num_parts": self._num_parts,
                "rng": _rng_state_to_json(self._epoch_rng_state)}

    def load_state_dict(self, state):
        # keyed by class: ImageRecordUInt8Iter's batches differ from
        # ImageRecordIter's over the same file
        _check_state_kind(state, type(self).__name__)
        # refuse configuration drift before touching any state
        for key, have in (("shuffle", bool(self.shuffle)),
                          ("batch_size", int(self.batch_size)),
                          ("num_records", len(self._keys)),
                          ("part_index", self._part_index),
                          ("num_parts", self._num_parts)):
            saved = state.get(key)
            if saved is not None and saved != have:
                raise ValueError(
                    "iterator state was saved with %s=%r but this "
                    "%s has %s=%r — resume needs the same "
                    "dataset, shard and configuration for a "
                    "bit-identical batch order"
                    % (key, saved, type(self).__name__, key, have))
        self._prefetcher.stop()  # no straggler draws after set_state
        self._rng.set_state(_rng_state_from_json(state["rng"]))
        self._epoch_num = int(state["epoch"]) - 1  # bumped back on start
        self._resume_consumed = int(state["batch"])
        self._start_epoch()

    def close(self):
        self._prefetcher.stop()
        self._pool.shutdown(wait=False)


class ImageDetRecordIter(ImageRecordIter):
    """Detection record iterator (src/io/iter_image_det_recordio.cc).

    Records carry variable-length labels ``[header_width, object_width,
    extra..., (id, xmin, ymin, xmax, ymax, ...) * n_obj]`` (im2rec's
    detection packing).  Each batch pads every label row to
    ``label_pad_width`` with ``label_pad_value`` (-1, the invalid-object
    marker that ``MultiBoxTarget`` masks out); a record wider than an
    explicit ``label_pad_width`` raises.  Crops and mirrors that would
    move the boxes (``rand_crop``, ``rand_mirror``) are refused: box-aware
    augmentation is ``image.ImageDetIter``'s.
    """

    _label_overflow_fatal = True

    def __init__(self, *args, label_pad_width=0, label_pad_value=-1.0,
                 **kwargs):
        self.label_pad_value = float(label_pad_value)
        if not label_pad_width:
            # unset: the widest record's label (iter_image_det_recordio.cc
            # :337), from every record's header, so a wide record late in
            # the file cannot overflow mid-epoch
            label_pad_width = self._estimate_label_width(args, kwargs)
        # set before the base constructor: its producer starts there
        kwargs["label_width"] = int(label_pad_width)
        super().__init__(*args, **kwargs)
        if self.rand_crop or self.rand_mirror:
            self.close()
            raise ValueError(
                "ImageDetRecordIter does not crop or mirror: the boxes "
                "would be invalidated; use image.ImageDetIter's detection "
                "augmenters")

    @staticmethod
    def _estimate_label_width(args, kwargs):
        """The widest label over all records.  A label's width is the IR
        header's ``flag`` (its count; 0 is a scalar label), so each
        record's framing and first 4 payload bytes are read and the image
        is skipped."""
        path = kwargs.get("path_imgrec", args[0] if args else None)
        width = 1
        with open(path, "rb") as fh:
            while True:
                offset = fh.tell()
                head = fh.read(8)
                if len(head) == 0:
                    break
                if len(head) < 8:
                    # a torn final record: the width of the intact part
                    _torn_final_record(path, offset,
                                       "only %d of 8 header bytes"
                                       % len(head))
                    break
                magic, lrec = struct.unpack("<II", head)
                if magic != _kMagic:
                    raise _corrupt_record_error(
                        path, offset,
                        "invalid record magic 0x%08X (expected 0x%08X)"
                        % (magic, _kMagic))
                cflag = lrec >> 29
                length = lrec & ((1 << 29) - 1)
                skip = length + ((4 - (length & 3)) & 3)
                if cflag in (0, 1) and length >= 4:
                    # a whole record or the first part of a split one:
                    # the IR header (flag = label count) leads the payload
                    buf = fh.read(4)
                    if len(buf) < 4:
                        _torn_final_record(path, offset,
                                           "payload cut inside the IR "
                                           "header")
                        break
                    flag = struct.unpack("<I", buf)[0]
                    width = max(width, flag if flag > 0 else 1)
                    skip -= 4
                fh.seek(skip, 1)  # continuation parts and image bytes
        return width


def _resize_shorter(img, size):
    from PIL import Image

    ih, iw = img.shape[:2]
    scale = size / min(ih, iw)
    nh, nw = max(int(round(ih * scale)), size), max(int(round(iw * scale)),
                                                    size)
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (nw, nh), Image.BILINEAR))


def _read_idx_file(path):
    """Parse an idx-format file (the MNIST container; gzip transparent)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}[
                     dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims).astype(dtype)


class ImageRecordUInt8Iter(ImageRecordIter):
    """ImageRecordIter emitting raw NCHW uint8 batches, not normalized:
    the consumer normalizes on the card.  A quarter of the float32
    batch's bytes to copy, and no host float pass."""

    _raw_bytes = True

    def __init__(self, *args, **kwargs):
        for k in ("mean_r", "mean_g", "mean_b", "std_r", "std_g", "std_b"):
            if k in kwargs:
                raise ValueError(
                    "ImageRecordUInt8Iter emits raw bytes; %s has no "
                    "effect — normalize in the consumer (device) instead "
                    "or use ImageRecordIter" % k)
        kwargs["dtype"] = "uint8"
        super().__init__(*args, **kwargs)


class MNISTIter(DataIter):
    """MNIST idx files as batches (``src/io/iter_mnist.cc``): images
    scaled to [0, 1] f32, (N, 1, 28, 28) or flat (N, 784); labels f32;
    every ``num_parts``-th sample from ``part_index``; the last batch
    padded.  ``shuffle`` draws as the reference's ``NDArrayIter`` does
    (its RNG seeded from numpy's global one).  Batches land on ``ctx``
    (``None``: the card)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=True, part_index=0, num_parts=1,
                 data_name="data", label_name="softmax_label", ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        img = _read_idx_file(image).astype(np.float32) / 255.0
        lab = _read_idx_file(label).astype(np.float32)
        img = img[part_index::num_parts]
        lab = lab[part_index::num_parts]
        img = img.reshape(len(img), -1) if flat \
            else img.reshape(len(img), 1, img.shape[1], img.shape[2])
        self._inner = NDArrayIter({data_name: img}, {label_name: lab},
                                  batch_size=batch_size, shuffle=shuffle,
                                  last_batch_handle="pad", ctx=ctx)

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
        return {"iter": "MNISTIter", "inner": self._inner.state_dict()}

    def load_state_dict(self, state):
        _check_state_kind(state, "MNISTIter")
        self._inner.load_state_dict(state["inner"])
