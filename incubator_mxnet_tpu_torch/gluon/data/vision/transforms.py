"""Vision transforms (port of
``incubator_mxnet_tpu/gluon/data/vision/transforms.py``): ``Compose``,
``Cast``, ``ToTensor``, ``Normalize``, ``Resize``, ``CenterCrop``,
``CropResize``, ``RandomResizedCrop``, the two flips, the colour jitters
and ``RandomLighting``, as ``Block``s on HWC (or NHWC) images.

A transform takes an NDArray, a tensor or a numpy array and returns an
NDArray on the input's device (the host, inside a ``DataLoader``).  The
values and dtypes are the reference's:

- Resizing is bilinear or nearest, as ``jax.image.resize``: bilinear
  antialiases when it shrinks (``F.interpolate(..., antialias=True)``),
  nearest is ``"nearest-exact"``.  A uint8 image is resized in float32
  and rounded half to even, then clipped, back to uint8.
- The random draws are the reference's calls in its order, on Python's
  global ``random`` (crops, flips, jitter factors, the jitter order) and
  numpy's global generator (``RandomLighting``), so that seeding both
  alike gives the reference's crops, flips and jitters.
- ``RandomContrast`` and ``RandomSaturation`` weigh the channels with a
  float64 grey, so their output is float64, as the reference's (it runs
  with 64-bit types on).
- Divisions are by tensors on the input's device (on the card a division
  by a Python number is a multiply by its reciprocal).
"""
from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as tF

from ....base import torch_dtype
from ....ndarray import NDArray
from ...block import Block

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "CropResize", "RandomResizedCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting"]


def _data(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def _wrap(t):
    return NDArray(t)


def _const(values, like, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype, device=like.device)


class Compose(Block):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        self._transforms = list(transforms)
        for t in self._transforms:
            if isinstance(t, Block):
                self.register_child(t)

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(Block):
    """The image as ``dtype``."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _wrap(_data(x).to(torch_dtype(self._dtype)))


class ToTensor(Block):
    """HWC [0, 255] to CHW float32 [0, 1] (NHWC to NCHW)."""

    def forward(self, x):
        d = _data(x).float()
        d = d / _const(255.0, d)
        if d.dim() == 3:
            d = d.permute(2, 0, 1)
        elif d.dim() == 4:
            d = d.permute(0, 3, 1, 2)
        return _wrap(d.contiguous())


class Normalize(Block):
    """``(x - mean) / std`` a channel, on CHW (or NCHW) input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32)
        self._std = np.asarray(std, dtype=np.float32)

    def forward(self, x):
        d = _data(x)
        mean, std = (torch.from_numpy(self._mean).to(d.device),
                     torch.from_numpy(self._std).to(d.device))
        if self._mean.ndim:
            lead = (1, -1, 1, 1) if d.dim() == 4 \
                else (-1,) + (1,) * (d.dim() - 1)
            mean, std = mean.reshape(lead), std.reshape(lead)
        return _wrap((d - mean) / std)


def _size_wh(size):
    if isinstance(size, (tuple, list)):
        return int(size[0]), int(size[1])
    return int(size), int(size)


def _resize_hwc(d, size, interpolation=1):
    """``d`` (HWC or NHWC) resized to ``size`` ((w, h) or an int) in
    float32."""
    w, h = _size_wh(size)
    x = d.float()
    x = x.unsqueeze(0) if x.dim() == 3 else x
    x = x.permute(0, 3, 1, 2)
    if interpolation == 0:
        y = tF.interpolate(x, size=(h, w), mode="nearest-exact")
    else:
        y = tF.interpolate(x, size=(h, w), mode="bilinear",
                           align_corners=False, antialias=True)
    y = y.permute(0, 2, 3, 1)
    return (y[0] if d.dim() == 3 else y).contiguous()


def _resize_keep_dtype(d, size, interpolation, orig_dtype):
    """Resize; a uint8 input comes back uint8 (rounded half to even,
    then clipped)."""
    out = _resize_hwc(d, size, interpolation)
    if orig_dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


def _hw(d):
    return (d.shape[0], d.shape[1]) if d.dim() == 3 else (d.shape[1],
                                                          d.shape[2])


class Resize(Block):
    """Resize to ``size`` ((w, h), or an int: a square, or with
    ``keep_ratio`` the shorter side); ``interpolation`` 0 is nearest,
    else bilinear."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        d = _data(x)
        size = self._size
        if self._keep and not isinstance(size, (tuple, list)):
            hgt, wid = _hw(d)
            if hgt > wid:
                size = (size, int(size * hgt / wid))
            else:
                size = (int(size * wid / hgt), size)
        return _wrap(_resize_keep_dtype(d, size, self._interpolation,
                                        d.dtype))


def _center_crop(d, size):
    w, h = _size_wh(size)
    H, W = _hw(d)
    y0 = max(0, (H - h) // 2)
    x0 = max(0, (W - w) // 2)
    if d.dim() == 3:
        return d[y0:y0 + h, x0:x0 + w, :]
    return d[:, y0:y0 + h, x0:x0 + w, :]


class CropResize(Block):
    """The window at (``x``, ``y``) of ``width`` x ``height``, resized to
    ``size`` when given; a window outside the image raises."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y = int(x), int(y)
        self._w, self._h = int(width), int(height)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        d = _data(x)
        H, W = _hw(d)
        if (self._x < 0 or self._y < 0 or self._w <= 0 or self._h <= 0
                or self._x + self._w > W or self._y + self._h > H):
            raise ValueError(
                "crop window (x=%d, y=%d, w=%d, h=%d) out of range for "
                "%dx%d image" % (self._x, self._y, self._w, self._h, W, H))
        if d.dim() == 3:
            out = d[self._y:self._y + self._h, self._x:self._x + self._w]
        else:
            out = d[:, self._y:self._y + self._h,
                    self._x:self._x + self._w]
        if self._size is not None:
            out = _resize_keep_dtype(out, self._size, self._interpolation,
                                     d.dtype)
        return _wrap(out)


class CenterCrop(Block):
    """The centred ``size`` window, resized to ``size`` where the image
    is smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        d = _data(x)
        out = _center_crop(d, self._size)
        H, W = _hw(out)
        if (W, H) != _size_wh(self._size):
            out = _resize_keep_dtype(out, self._size, self._interpolation,
                                     d.dtype)
        return _wrap(out)


class RandomResizedCrop(Block):
    """A window of random area (``scale`` of the image's) and aspect
    (``ratio``), resized to ``size``; after 10 misses the centred square."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        d = _data(x)
        assert d.dim() == 3, "RandomResizedCrop expects HWC image"
        H, W = d.shape[0], d.shape[1]
        area = H * W
        for _ in range(10):
            target_area = random.uniform(*self._scale) * area
            aspect = random.uniform(*self._ratio)
            w = int(round((target_area * aspect) ** 0.5))
            h = int(round((target_area / aspect) ** 0.5))
            if w <= W and h <= H:
                x0 = random.randint(0, W - w)
                y0 = random.randint(0, H - h)
                crop = d[y0:y0 + h, x0:x0 + w, :]
                break
        else:
            crop = _center_crop(d, min(H, W))
        return _wrap(_resize_keep_dtype(crop, self._size,
                                        self._interpolation, d.dtype))


class RandomFlipLeftRight(Block):
    """A mirror across the width, with probability 1/2."""

    def forward(self, x):
        d = _data(x)
        if random.random() < 0.5 and d.dim() >= 2:
            d = torch.flip(d, dims=(-2,))
        return _wrap(d)


class RandomFlipTopBottom(Block):
    """A mirror across the height, with probability 1/2."""

    def forward(self, x):
        d = _data(x)
        if random.random() < 0.5:
            d = torch.flip(d, dims=(0 if d.dim() == 3 else 1,))
        return _wrap(d)


class _RandomJitterBase(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _alpha(self):
        return 1.0 + random.uniform(-self._amount, self._amount)


_GREY = [[[0.299, 0.587, 0.114]]]


class RandomBrightness(_RandomJitterBase):
    """``x * alpha``, ``alpha`` uniform in 1 +- ``amount``; clipped to
    [0, 255]."""

    def forward(self, x):
        d = _data(x).float()
        return _wrap(torch.clamp(d * self._alpha(), 0, 255))


class RandomContrast(_RandomJitterBase):
    """Blend with the image's mean grey; clipped to [0, 255]."""

    def forward(self, x):
        d = _data(x).float()
        alpha = self._alpha()
        gray = torch.mean(d * _const(_GREY, d, torch.float64))
        return _wrap(torch.clamp((d * alpha).double() + gray * (1.0 - alpha),
                                 0, 255))


class RandomSaturation(_RandomJitterBase):
    """Blend with each pixel's grey; clipped to [0, 255]."""

    def forward(self, x):
        d = _data(x).float()
        alpha = self._alpha()
        gray = torch.sum(d * _const(_GREY, d, torch.float64), dim=-1,
                         keepdim=True)
        return _wrap(torch.clamp(d * alpha + gray * (1.0 - alpha), 0, 255))


class RandomHue(_RandomJitterBase):
    """A rotation of the hue in YIQ space by up to ``amount`` half turns;
    clipped to [0, 255]."""

    def forward(self, x):
        d = _data(x).float()
        alpha = random.uniform(-self._amount, self._amount)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]])
        tyiq = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]])
        ityiq = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]])
        t = ityiq @ bt @ tyiq
        return _wrap(torch.clamp(d @ _const(t.T.tolist(), d), 0, 255))


class RandomColorJitter(Block):
    """The nonzero jitters of brightness, contrast, saturation and hue,
    in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        random.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise of scale ``alpha``; clipped to [0,
    255]."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        d = _data(x).float()
        alpha = np.random.normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _wrap(torch.clamp(d + torch.from_numpy(rgb).to(d.device),
                                 0, 255))
