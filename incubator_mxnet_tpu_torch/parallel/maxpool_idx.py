"""Max pooling that stores the winning in-window slot (port of
``incubator_mxnet_tpu/parallel/maxpool_idx.py``).

The forward emits the pooled maximum (-inf padding) and an int8 plane
holding the first row-major in-window argmax; the backward
(:func:`indexed_unpool`) routes each output gradient to its winner from
that plane alone, with no re-read of the input.  On a CUDA tensor the
forward is the hand-written kernel K3 (``csrc/maxpool_idx.cu``); on a CPU
tensor it is :func:`_maxpool_plain`, which repeats the reference
kernel's arithmetic.
"""
from __future__ import annotations

import itertools

import torch

from .. import _kernels

__all__ = ["check_shape", "maxpool_with_index", "indexed_unpool",
           "max_pool"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_shape(shape, window, strides, padding):
    """The reference ``plan``'s shape rules: rank 4, no pooling over N or
    C, 2 to 127 in-window slots (the index plane is int8).  Returns the
    output (OH, OW); raises ValueError on anything else.

    ``window``/``strides`` are full-rank NCHW (leading (1, 1));
    ``padding`` is ``((0, 0), (0, 0), (ph, ph'), (pw, pw'))``."""
    if len(shape) != 4 or len(window) != 4 or len(strides) != 4 \
            or len(padding) != 4:
        raise ValueError("max pooling with index takes rank-4 NCHW")
    if tuple(window[:2]) != (1, 1) or tuple(strides[:2]) != (1, 1) \
            or tuple(padding[0]) != (0, 0) or tuple(padding[1]) != (0, 0):
        raise ValueError("max pooling with index does not pool over N or C")
    if not 2 <= window[2] * window[3] <= 127:
        raise ValueError("max pooling with index takes 2 to 127 window "
                         "slots, got %d" % (window[2] * window[3]))
    _, _, h, w = shape
    oh = (h + sum(padding[2]) - window[2]) // strides[2] + 1
    ow = (w + sum(padding[3]) - window[3]) // strides[3] + 1
    if oh < 1 or ow < 1:
        raise ValueError("pooling window larger than the padded input")
    return oh, ow


def _maxpool_plain(data, window, strides, padding):
    """The reference kernel's arithmetic in torch: pad with -inf, visit
    the window slots in row-major order, keep the earlier slot on ties
    (strict >)."""
    oh, ow = check_shape(data.shape, window, strides, padding)
    xp = torch.nn.functional.pad(
        data, (padding[3][0], padding[3][1], padding[2][0], padding[2][1]),
        value=float("-inf"))
    sh, sw = strides[2], strides[3]
    best = idx = None
    for lin, (i, j) in enumerate(itertools.product(range(window[2]),
                                                   range(window[3]))):
        xs = xp[:, :, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
        if best is None:
            best = xs
            idx = torch.zeros(xs.shape, dtype=torch.int8, device=data.device)
        else:
            idx = torch.where(xs > best, torch.full((), lin, dtype=torch.int8,
                                                    device=data.device), idx)
            best = torch.maximum(best, xs)
    return best.contiguous(), idx


def maxpool_with_index(data, window, strides, padding):
    """``(out, idx)``: the pooled max in data's dtype and the int8 winner
    slot.  CUDA tensors go through K3; CPU tensors through the plain
    version."""
    if data.dtype not in _DTYPE_CODE:
        raise TypeError("max pooling with index takes float32 or bfloat16, "
                        "got %s" % data.dtype)
    if data.device.type == "cpu":
        return _maxpool_plain(data, window, strides, padding)
    if data.device.type != "cuda":
        raise ValueError("max pooling runs on cuda or cpu, got %s"
                         % data.device)
    oh, ow = check_shape(data.shape, window, strides, padding)
    if not data.is_contiguous():
        raise ValueError("max pooling with index takes contiguous NCHW")
    n, c, h, w = data.shape
    out = torch.empty((n, c, oh, ow), dtype=data.dtype, device=data.device)
    idx = torch.empty((n, c, oh, ow), dtype=torch.int8, device=data.device)
    _kernels.KERNELS["maxpool_idx_fwd"].launch(
        data.device, _DTYPE_CODE[data.dtype], data.data_ptr(), out.data_ptr(),
        idx.data_ptr(), n, c, h, w, oh, ow, window[2], window[3], strides[2],
        strides[3], padding[2][0], padding[3][0])
    return out, idx


def indexed_unpool(first, g, in_shape, window, strides, padding):
    """Backward from the saved index plane alone (maxpool_idx.py
    ``indexed_unpool``): ``dx[p] += g[w]`` exactly when window ``w``
    covers ``p`` at slot ``first[w]``.  Contributions are added slot by
    slot, in the reference's order, into a padded buffer whose pad cells
    are then cut away (a -inf pad cell never wins, so nothing is lost)."""
    n, c, h, w = in_shape
    oh, ow = g.shape[2], g.shape[3]
    (plo_h, phi_h), (plo_w, phi_w) = padding[2], padding[3]
    sh, sw = strides[2], strides[3]
    dxp = torch.zeros((n, c, h + plo_h + phi_h, w + plo_w + phi_w),
                      dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for lin, (i, j) in enumerate(itertools.product(range(window[2]),
                                                   range(window[3]))):
        contrib = torch.where(first == lin, g, zero)
        dxp[:, :, i:i + (oh - 1) * sh + 1:sh,
            j:j + (ow - 1) * sw + 1:sw] += contrib
    return dxp[:, :, plo_h:plo_h + h, plo_w:plo_w + w]


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, window, strides, padding):
        out, idx = maxpool_with_index(data, window, strides, padding)
        ctx.save_for_backward(idx)
        ctx.cfg = (tuple(data.shape), window, strides, padding)
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        in_shape, window, strides, padding = ctx.cfg
        return (indexed_unpool(idx, g, in_shape, window, strides, padding),
                None, None, None)


def max_pool(data, window, strides, padding):
    """Differentiable max pooling: forward through :func:`maxpool_with_index`,
    backward through :func:`indexed_unpool`."""
    window = tuple(int(k) for k in window)
    strides = tuple(int(s) for s in strides)
    padding = tuple(tuple(int(p) for p in q) for q in padding)
    return _MaxPool.apply(data, window, strides, padding)
