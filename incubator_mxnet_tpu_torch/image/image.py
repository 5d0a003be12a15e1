"""``mx.image``: image loading, augmentation and ``ImageIter`` (port of
``incubator_mxnet_tpu/image/image.py``; reference: python/mxnet/image/
image.py — imdecode :95, imresize :136, ImageIter :1139, Augmenter :615,
CreateAugmenter :1002).

PIL decodes on the host (numpy HWC uint8) and every augmenter is numpy,
as in the JAX package, so both give the same images from the same bytes
and the same ``random`` draws.  An image between augmenters is an
NDArray on the CPU, as upstream MXNet's ``imdecode`` gives one; only the
finished batch goes to the iterator's ``ctx`` (``None``: the CUDA card),
one host-to-device copy a batch.  PIL is imported inside the functions
that need it.
"""
from __future__ import annotations

import io as _io
import os
import random as _pyrandom
from typing import List

import numpy as np

from .. import context, recordio
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray
from ..ndarray import ndarray as nd

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop",
           "color_normalize", "Augmenter", "SequentialAug", "RandomOrderAug",
           "CastAug", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "HorizontalFlipAug", "CreateAugmenter",
           "ImageIter"]


def _host(a, dtype=None):
    """``a`` as an NDArray on the CPU."""
    return nd.array(a, ctx=context.cpu(), dtype=dtype)


def _to_nd(a):
    return a if isinstance(a, NDArray) else _host(a)


def _to_np(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode an image byte buffer → HWC uint8 NDArray (image.py:95)."""
    from PIL import Image
    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        img = img.convert("L")
        arr = np.asarray(img)[:, :, None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img)
        if not to_rgb:
            arr = arr[:, :, ::-1]  # BGR like OpenCV default
    return _host(np.ascontiguousarray(arr), dtype="uint8")


def imread(filename, flag=1, to_rgb=True):
    """Read an image file (image.py:180)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


_PIL_INTERP = {0: 0, 1: 2, 2: 3, 3: 0, 4: 1}  # cv2 code → PIL resample


def imresize(src, w, h, interp=1):
    """Resize to exactly (w, h) (image.py:136)."""
    from PIL import Image
    arr = _to_np(src)
    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr.squeeze(-1) if squeeze else arr)
    img = img.resize((int(w), int(h)), _PIL_INTERP.get(interp, 2))
    out = np.asarray(img)
    if squeeze:
        out = out[:, :, None]
    return _host(out, dtype=str(arr.dtype))


def resize_short(src, size, interp=2):
    """Resize shorter edge to ``size`` keeping aspect (image.py:349)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a fixed region, optionally resize (image.py:393)."""
    arr = _to_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return _host(out, dtype=str(arr.dtype))


def center_crop(src, size, interp=2):
    """Center crop → (cropped, (x0, y0, w, h)) (image.py:470)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = int((w - new_w) / 2)
    y0 = int((h - new_h) / 2)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    """Uniform random crop → (cropped, region) (image.py:429)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random area+aspect crop (Inception-style) (image.py:523)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std (image.py:500)."""
    arr = _to_np(src).astype(np.float32)
    arr = arr - _to_np(mean).astype(np.float32)
    if std is not None:
        arr = arr / _to_np(std).astype(np.float32)
    return _host(arr.astype(np.float32))


# ---------------------------------------------------------------------------
# augmenters (image.py:615-1000)
# ---------------------------------------------------------------------------

class Augmenter:
    """Base augmenter (image.py:615)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_to_np(src).astype(self.typ))


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _host(_to_np(src)[:, ::-1].copy())
        return _to_nd(src)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return _host(_to_np(src).astype(np.float32) * alpha)


_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = _to_np(src).astype(np.float32)
        gray = (arr * _GRAY).sum(axis=2, keepdims=True).mean()
        return _host(arr * alpha + gray * (1 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = _to_np(src).astype(np.float32)
        gray = (arr * _GRAY).sum(axis=2, keepdims=True)
        return _host(arr * alpha + gray * (1 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        arr = _to_np(src).astype(np.float32)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], np.float32)
        t_rgb = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
        m = t_rgb @ rot @ t_yiq
        return _host(arr @ m.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA noise (AlexNet-style) (image.py:906)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _to_np(eigval)
        self.eigvec = _to_np(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _host(_to_np(src).astype(np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = _to_np(src).astype(np.float32)
            gray = (arr * _GRAY).sum(axis=2, keepdims=True)
            return _host(np.repeat(gray, 3, axis=2))
        return _to_nd(src)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,  # noqa: N802
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmenter pipeline factory (image.py:1002)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4., 4 / 3.), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(
            mean if mean is not None else np.zeros(3, np.float32), std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter (image.py:1139)
# ---------------------------------------------------------------------------

class ImageIter(DataIter):
    """Image iterator reading .rec files or an image list, with augmenter
    chain; emits NCHW float batches on ``ctx`` (``None``: the CUDA card)
    (image.py:1139)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", ctx=None, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise ValueError("data_shape must be (C, H, W) with C 1 or 3, "
                             "got %r" % (data_shape,))
        self.ctx = context.resolve(ctx)
        self.data_shape = data_shape
        self.label_width = label_width
        self.path_root = path_root
        self.shuffle = shuffle
        self.dtype = dtype

        self.imgrec = None
        self.imglist = None
        if path_imgrec:
            if path_imgidx and os.path.exists(path_imgidx):
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist or imglist is not None:
            entries = {}
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        label = np.array(parts[1:-1], np.float32)
                        entries[int(parts[0])] = (label, parts[-1])
            else:
                for i, item in enumerate(imglist):
                    label = np.array(item[0] if isinstance(item[0],
                                                           (list, tuple))
                                     else [item[0]], np.float32)
                    entries[i] = (label, item[1])
            self.imglist = entries
            self.seq = list(entries.keys())
        else:
            raise ValueError("path_imgrec, path_imglist or imglist required")

        if num_parts > 1 and self.seq is not None:
            n_per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n_per:(part_index + 1) * n_per]

        if aug_list is None:
            aug_list = CreateAugmenter(data_shape)
        self.auglist = aug_list

        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + data_shape, dtype)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, label_width)
                                       if label_width > 1
                                       else (batch_size,), dtype)]
        self.cur = 0
        self.reset()

    def reset(self):
        self.cur = 0
        if self.shuffle and self.seq is not None:
            _pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()

    def next_sample(self):
        """Next (label, decoded image array) (image.py:1246)."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                label = header.label
                return label, imdecode(img)
            label, fname = self.imglist[idx]
            return label, imread(os.path.join(self.path_root, fname))
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, imdecode(img)

    def next(self):  # noqa: A003
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, img = self.next_sample()
                for aug in self.auglist:
                    img = aug(img)
                arr = _to_np(img)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                batch_data[i] = arr
                batch_label[i] = np.asarray(label, np.float32).reshape(-1)[
                    :self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        data = nd.array(batch_data.transpose(0, 3, 1, 2), ctx=self.ctx,
                        dtype=self.dtype)
        label = nd.array(batch_label if self.label_width > 1
                         else batch_label[:, 0], ctx=self.ctx,
                         dtype=self.dtype)
        return DataBatch([data], [label], pad=pad)
