"""Dtype names (port of ``incubator_mxnet_tpu/base.py``'s ``np_dtype``).

The port keeps its own copy: it never imports the JAX package.  A dtype
may be given as a name (``"float32"``, ``"bfloat16"``, ...), a numpy
dtype or type, or a ``torch.dtype``; :func:`torch_dtype` and
:func:`np_dtype` map any of them to the one the caller needs.  ``None``
is float32, as in the reference.  :class:`MXNetError` is the
framework's error, as the reference's ``mxnet.base.MXNetError``.  The
``np_*`` helpers give the NumPy frontend ``jax.numpy``'s type promotion.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "np_dtype", "torch_dtype", "dtype_name",
           "np_promote_types", "np_result_type", "np_inexact"]


class MXNetError(RuntimeError):
    """Error raised by the framework (``mxnet.base.MXNetError``)."""


_BY_NAME = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
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


# -- NumPy-frontend type promotion -------------------------------------------
# The reference's ``mx.np`` and ``_npi_*`` ops follow ``jax.numpy`` with
# 64-bit types on: arrays are strongly typed; Python scalars are weak
# (they take the array's type within its kind); integers and booleans that
# meet a Python float become float64.
_KIND = {torch.bool: "b", torch.uint8: "u", torch.int8: "i",
         torch.int16: "i", torch.int32: "i", torch.int64: "i",
         torch.float16: "f", torch.bfloat16: "f", torch.float32: "f",
         torch.float64: "f", torch.complex64: "c", torch.complex128: "c"}
_RANK = {"b": 0, "u": 1, "i": 1, "f": 2, "c": 3}
_WEAK = {bool: "b", int: "i", float: "f", complex: "c"}
_DEFAULT = {"b": torch.bool, "i": torch.int64, "u": torch.int64,
            "f": torch.float64, "c": torch.complex128}


def _bits(dt):
    return torch.finfo(dt).bits if dt.is_floating_point or dt.is_complex \
        else (1 if dt == torch.bool else torch.iinfo(dt).bits)


def np_promote_types(a, b):
    """The join of two strong torch dtypes in ``jax.numpy``'s lattice
    (``jnp.promote_types``)."""
    if a == b:
        return a
    ka, kb = _KIND[a], _KIND[b]
    if ka == "b":
        return b
    if kb == "b":
        return a
    if _RANK[ka] > _RANK[kb]:
        a, b, ka, kb = b, a, kb, ka
    if ka == kb == "f":
        if {a, b} == {torch.float16, torch.bfloat16}:
            return torch.float32
        return a if _bits(a) > _bits(b) else b
    if ka == kb == "c":
        return a if _bits(a) > _bits(b) else b
    if ka == kb:  # both signed, or both unsigned
        return a if _bits(a) > _bits(b) else b
    if {ka, kb} == {"u", "i"}:
        u, i = (a, b) if ka == "u" else (b, a)
        if _bits(i) > _bits(u):
            return i
        return {8: torch.int16, 16: torch.int32, 32: torch.int64}.get(
            _bits(u), torch.float64)
    if kb == "c" and ka == "f":
        return torch.complex128 if _bits(a) > 32 else b
    return b  # an integer meets a float or a complex type: the latter


def np_result_type(*args) -> torch.dtype:
    """The dtype ``jax.numpy`` gives an elementwise function of ``args``
    (tensors, numpy arrays and dtypes are strong, Python scalars weak)."""
    strong, weak = None, None
    for a in args:
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            dt = a.dtype
        elif isinstance(a, torch.dtype):
            dt = a
        elif type(a) in _WEAK:
            k = _WEAK[type(a)]
            weak = k if weak is None or _RANK[k] > _RANK[weak] else weak
            continue
        elif hasattr(a, "dtype"):
            dt = torch_dtype(a.dtype)
        else:
            continue
        strong = dt if strong is None else np_promote_types(strong, dt)
    if strong is None:
        return _DEFAULT[weak or "f"]
    if weak is None or _RANK[weak] <= _RANK[_KIND[strong]]:
        return strong
    if weak == "c":
        return torch.complex64 if strong == torch.float32 \
            else torch.complex128
    return _DEFAULT[weak]


def np_inexact(dtype) -> torch.dtype:
    """The type ``jax.numpy`` computes an inexact function of ``dtype``
    in: a floating or complex type stays; int64 becomes float64 and the
    narrower integers and booleans float32."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.int64 else torch.float32
