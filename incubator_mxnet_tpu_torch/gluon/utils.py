"""Gluon utilities (port of ``incubator_mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm`` and
``check_sha1``; ``download`` raises, as in the reference (no network)."""
from __future__ import annotations

import hashlib
from typing import List

import torch

from ..ndarray import NDArray
from ..ndarray import ndarray as _nd

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder unless ``even_split`` demands none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices"
            % (str(data.shape), num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` and put slice i on
    ``ctx_list[i]`` (one context: the whole batch there)."""
    if not isinstance(data, NDArray):
        data = _nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so their joint L2 norm (taken in f32)
    is at most ``max_norm``; returns that norm as a float."""
    total = torch.sqrt(sum(a._data.float().square().sum() for a in arrays))
    total_f = float(total)
    scale = max_norm / (total_f + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a._data.copy_(a._data * scale)
    return total_f


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise RuntimeError(
        "download() requires network egress which is unavailable in this "
        "environment; place files locally instead")
