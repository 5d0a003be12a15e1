"""``mx.image`` detection iterator (port of
``incubator_mxnet_tpu/image/detection.py``; reference:
python/mxnet/image/detection.py — ImageDetIter :626).

Labels are object lists: each image's label is (N_obj, 5+) rows
[class, xmin, ymin, xmax, ymax, ...] in normalized coords, padded with -1
rows to the batch-wide maximum (the header format MultiBoxTarget
consumes).  Batches land on the iterator's ``ctx`` (``None``: the CUDA
card)."""
from __future__ import annotations

import random as _pyrandom
from typing import List

import numpy as np

from ..io.io import DataBatch, DataDesc
from ..ndarray import ndarray as nd
from .image import Augmenter, ImageIter, _host, _to_np, imresize

__all__ = ["ImageDetIter", "DetAugmenter", "DetHorizontalFlipAug",
           "DetBorrowAug", "CreateDetAugmenter"]


class DetAugmenter:
    """Augmenter operating on (image, label) jointly (detection.py:41)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter (detection.py:116)."""

    def __init__(self, augmenter: Augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and mirror box x-coords (detection.py:147)."""

    def __init__(self, p):
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _host(_to_np(src)[:, ::-1].copy())
            valid = label[:, 0] >= 0
            tmp = 1.0 - label[valid, 1]
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = tmp
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_mirror=False, mean=None,  # noqa: N802
                       std=None, **kwargs):
    """Standard detection augmenter chain (detection.py:489)."""
    from .image import (CastAug, ColorNormalizeAug, ForceResizeAug)
    auglist: List[DetAugmenter] = []
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]))))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            mean if mean is not None else np.zeros(3, np.float32), std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: object-list labels (detection.py:626)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", imglist=None,
                 shuffle=False, aug_list=None, data_name="data",
                 label_name="label", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        super().__init__(batch_size, data_shape, label_width=-1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, imglist=imglist,
                         shuffle=shuffle, aug_list=[],
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        if self.imglist is not None:
            # imglist labels are documented flat [cls, x1, y1, x2, y2]*N;
            # ALWAYS synthesize the packed [2, 5] header (guessing whether
            # a label is pre-packed misclassifies flat labels whose first
            # values look like a header)
            for key, (lab, fname) in list(self.imglist.items()):
                flat = np.asarray(lab, np.float32).reshape(-1)
                assert flat.size % 5 == 0, \
                    "imglist detection label must be [cls,x1,y1,x2,y2]*N"
                self.imglist[key] = (
                    np.concatenate([[2.0, 5.0], flat]).astype(np.float32),
                    fname)
        self.det_auglist = aug_list
        # probe max objects to fix the label pad shape
        self.max_objects = self._estimate_label_shape()
        self.provide_label = [DataDesc(
            label_name, (batch_size, self.max_objects, 5), "float32")]

    def _parse_label(self, label):
        """Packed label → (N_obj, obj_width) [cls, x1, y1, x2, y2, ...]
        (detection.py:772: header = [header_width, obj_width, extras...]).

        Every label must carry the header (imglist entries get one
        synthesized at construction); malformed labels raise instead of
        being silently reinterpreted."""
        raw = np.asarray(label, np.float32).reshape(-1)
        if raw.size >= 2:
            header_width = int(raw[0])
            obj_width = int(raw[1])
            if 2 <= header_width < raw.size and obj_width >= 5 and \
                    (raw.size - header_width) % obj_width == 0:
                return raw[header_width:].reshape(-1, obj_width)
        raise ValueError(
            "invalid detection label of size %d: expected packed header "
            "[header_width, obj_width, ...] followed by objects "
            "(detection.py pack_label format)" % raw.size)

    def _iter_labels(self):
        """Yield labels only — record headers are unpacked without JPEG
        decode (the reference scans packed label headers the same way,
        detection.py:700)."""
        from .. import recordio as _rec
        if self.imglist is not None:
            for label, _ in self.imglist.values():
                yield label
            return
        if self.seq is not None:
            for idx in self.seq:
                header, _ = _rec.unpack(self.imgrec.read_idx(idx))
                yield header.label
            return
        self.imgrec.reset()
        while True:
            s = self.imgrec.read()
            if s is None:
                break
            header, _ = _rec.unpack(s)
            yield header.label
        self.imgrec.reset()

    def _estimate_label_shape(self):
        max_count = 1
        for label in self._iter_labels():
            max_count = max(max_count, self._parse_label(label).shape[0])
        self.reset()
        return max_count

    def next(self):  # noqa: A003
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), np.float32)
        batch_label = np.full((self.batch_size, self.max_objects, 5), -1.0,
                              np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, img = self.next_sample()
                objs = self._parse_label(label).copy()
                for aug in self.det_auglist:
                    img, objs = aug(img, objs)
                arr = _to_np(img)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                if arr.shape[:2] != (h, w):
                    arr = _to_np(imresize(arr, w, h))
                batch_data[i] = arr
                n = min(objs.shape[0], self.max_objects)
                batch_label[i, :n] = objs[:n]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        data = nd.array(batch_data.transpose(0, 3, 1, 2), ctx=self.ctx)
        return DataBatch([data], [nd.array(batch_label, ctx=self.ctx)],
                         pad=pad)
