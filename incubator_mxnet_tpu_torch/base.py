"""Dtype names (port of ``incubator_mxnet_tpu/base.py``'s ``np_dtype``).

The port keeps its own copy: it never imports the JAX package.  A dtype
may be given as a name (``"float32"``, ``"bfloat16"``, ...), a numpy
dtype or type, or a ``torch.dtype``; :func:`torch_dtype` and
:func:`np_dtype` map any of them to the one the caller needs.  ``None``
is float32, as in the reference.  :class:`MXNetError` is the
framework's error, as the reference's ``mxnet.base.MXNetError``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "np_dtype", "torch_dtype", "dtype_name"]


class MXNetError(RuntimeError):
    """Error raised by the framework (``mxnet.base.MXNetError``)."""


_BY_NAME = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError("dtype %r is not one the port supports (%s)"
                        % (dtype, ", ".join(_BY_NAME))) from None


def dtype_name(dtype) -> str:
    """The reference's name of ``dtype`` (``"float32"``, ``"bfloat16"``)."""
    return _NAME_OF[torch_dtype(dtype)]


def np_dtype(dtype) -> np.dtype:
    """``dtype`` as a numpy dtype.  numpy has no bfloat16 of its own:
    ``ml_dtypes``' is used where it is installed, as the reference does,
    and its absence raises."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError("bfloat16 has no numpy dtype without ml_dtypes; "
                            "cast to float32 first") from None
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)
