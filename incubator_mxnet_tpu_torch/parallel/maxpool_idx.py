"""Max pooling that stores the winning in-window slot (port of
``incubator_mxnet_tpu/parallel/maxpool_idx.py``).

The forward emits the pooled maximum (-inf padding) and an int8 plane
holding the first row-major in-window argmax; the backward
(:func:`indexed_unpool`) routes each output gradient to its winner from
that plane alone, with no re-read of the input.  On a CUDA tensor the
forward is the hand-written kernel K3 (``csrc/maxpool_idx.cu``), which
stages each band of a plane's input rows in shared memory with one bulk
copy (:func:`band_rows`); on a CPU tensor it is :func:`_maxpool_plain`,
which repeats the reference kernel's arithmetic.  K3 reads contiguous
NCHW: on the card another layout (a permuted or ``channels_last``
tensor, a strided view) is copied once into a fresh contiguous tensor
first, as JAX arrays, which have no strides, compute it; a storage
offset off the 16-byte grid needs no copy.

:func:`max_pool` routes as the reference's ``plan``: 2 to 127 window
slots in a floating dtype go through :func:`maxpool_with_index` (K3 on
the card: f32, bf16, f16, f64); a 1-slot window, more than 127 slots
or an integer dtype, which the reference pools outside its kernel, go
through :func:`_maxpool_plain` on any device, with the same winner
(int32 beyond 127 slots) and the same backward.
"""
from __future__ import annotations

import itertools

import torch

from .. import _kernels

__all__ = ["check_shape", "maxpool_with_index", "indexed_unpool",
           "max_pool", "band_rows"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}


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
    return _out_hw(shape, window, strides, padding)


def _out_hw(shape, window, strides, padding):
    _, _, h, w = shape
    oh = (h + sum(padding[2]) - window[2]) // strides[2] + 1
    ow = (w + sum(padding[3]) - window[3]) // strides[3] + 1
    if oh < 1 or ow < 1:
        raise ValueError("pooling window larger than the padded input")
    return oh, ow


def _slot_views(data, window, strides, padding):
    """For each window slot in row-major order, the strided view of
    ``data`` padded with its dtype's lowest value (-inf for floats) that
    the slot sees in every window."""
    oh, ow = _out_hw(data.shape, window, strides, padding)
    low = float("-inf") if data.is_floating_point() \
        else torch.iinfo(data.dtype).min
    xp = torch.nn.functional.pad(
        data, (padding[3][0], padding[3][1], padding[2][0], padding[2][1]),
        value=low)
    sh, sw = strides[2], strides[3]
    return [xp[:, :, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            for i, j in itertools.product(range(window[2]), range(window[3]))]


def _maxpool_plain(data, window, strides, padding):
    """The reference kernel's arithmetic in torch: pad with the dtype's
    lowest value (-inf for floats), visit the window slots in row-major
    order, keep the earlier slot on ties (strict >).  Any number of
    slots and any dtype; the winner plane is int8 up to 127 slots, as the
    kernel's, else int32.  A window holding NaN pools to NaN and keeps
    the slot it had, as the kernel does."""
    views = _slot_views(data, window, strides, padding)
    idx_dtype = torch.int8 if len(views) <= 127 else torch.int32
    best = views[0]
    idx = torch.zeros(best.shape, dtype=idx_dtype, device=data.device)
    for lin, xs in enumerate(views[1:], 1):
        idx = torch.where(xs > best, torch.full((), lin, dtype=idx_dtype,
                                                device=data.device), idx)
        best = torch.maximum(best, xs)
    return best.contiguous(), idx


def _on_card(t):
    """True where K3 runs: a CUDA tensor."""
    return t.device.type == "cuda"


def _dense(t):
    """``t`` as K3 reads it: itself where it is contiguous NCHW, else one
    contiguous copy (module note)."""
    return t.contiguous()


def maxpool_with_index(data, window, strides, padding):
    """``(out, idx)``: the pooled max in data's dtype and the int8 winner
    slot.  CUDA tensors go through K3 (copied first where they are not
    contiguous NCHW), f32, bf16, f16 or f64; CPU tensors through the
    plain version; ``meta`` tensors get empty outputs."""
    if data.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError("max pooling runs on cuda or cpu, got %s"
                         % data.device)
    oh, ow = check_shape(data.shape, window, strides, padding)
    n, c, h, w = data.shape
    if data.device.type == "meta":  # shape inference
        return (torch.empty((n, c, oh, ow), dtype=data.dtype, device="meta"),
                torch.empty((n, c, oh, ow), dtype=torch.int8, device="meta"))
    if not _on_card(data):
        return _maxpool_plain(data, window, strides, padding)
    if data.dtype not in _DTYPE_CODE:
        raise TypeError("max pooling with index takes float32, bfloat16, "
                        "float16 or float64, got %s" % data.dtype)
    out = torch.empty((n, c, oh, ow), dtype=data.dtype, device=data.device)
    idx = torch.empty((n, c, oh, ow), dtype=torch.int8, device=data.device)
    data = _dense(data)
    _kernels.KERNELS["maxpool_idx_fwd"].launch(
        data.device, _DTYPE_CODE[data.dtype], data.data_ptr(), out.data_ptr(),
        idx.data_ptr(), n, c, h, w, oh, ow, window[2], window[3], strides[2],
        strides[3], padding[2][0], padding[3][0])
    return out, idx


def band_rows(data, window, strides, padding):
    """The output rows a band of K3 stages for ``data`` (a whole plane's
    ``OH`` where its input rows fit the kernel's stage), or 0 where the
    launch reads device memory directly, as the built kernel plans it
    (the ``maxpool_idx_band_rows`` entry).  Builds the library if needed;
    launches nothing."""
    oh, _ = check_shape(data.shape, window, strides, padding)
    _, _, h, w = data.shape
    return _kernels.query("maxpool_idx_band_rows", _DTYPE_CODE[data.dtype],
                          h, w, oh, window[2], strides[2])


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


def _indexed(data, window):
    """True where the reference's ``plan`` places its kernel: 2 to 127
    window slots in a floating dtype."""
    return 2 <= window[2] * window[3] <= 127 and data.is_floating_point()


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, window, strides, padding):
        pool = maxpool_with_index if _indexed(data, window) \
            else _maxpool_plain
        out, idx = pool(data, window, strides, padding)
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
    """Differentiable max pooling (module note): the pooled maximum and
    its winner plane, from :func:`maxpool_with_index` where the
    reference places its kernel and from :func:`_maxpool_plain`
    elsewhere; the backward :func:`indexed_unpool` from that plane."""
    window = tuple(int(k) for k in window)
    strides = tuple(int(s) for s in strides)
    padding = tuple(tuple(int(p) for p in q) for q in padding)
    return _MaxPool.apply(data, window, strides, padding)
