"""The stock MXNet ``.params`` container (port of
``incubator_mxnet_tpu/ndarray/legacy_io.py``, dense arrays).

This is how weights cross between the JAX package and the port: both
write the same bytes for the same arrays, and each reads the other's
files.

  file   := uint64 kMXAPINDArrayListMagic(0x112) | uint64 reserved(0)
            | vec<ndarray> | vec<string names>          (ndarray.cc:1831-1857)
  vec<T> := uint64 count | T...
  string := uint64 len | bytes
  ndarray(V2/V3) := uint32 magic(0xF993fac9/a) | int32 stype | shape
            | int32 dev_type | int32 dev_id | int32 type_flag | raw data
  shape  := int32 ndim | int64 dim...
  legacy V1 (0xF993fac8): shape | ctx | type_flag | data; pre-V1: the
  "magic" word is ndim followed by uint32 dims          (ndarray.cc:1672-1717)

Type flags: f32=0 f64=1 f16=2 u8=3 i32=4 i8=5 i64=6 bool=7
(``mshadow/base.h``).  The table has no bfloat16: a bfloat16 array is
written as float32, as the reference writes it, so its values come back
exactly and its dtype as float32.  Every array is written with the CPU's
device type, as the reference does.  Sparse storage (stype 1, 2) is not
in the port yet (ROADMAP A13) and raises.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np

__all__ = ["MAGIC_LIST", "is_legacy_container", "save_legacy",
           "load_legacy_buffer"]

MAGIC_LIST = 0x112
_V1 = 0xF993FAC8
_V2 = 0xF993FAC9
_V3 = 0xF993FACA

_FLAG_OF = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
            np.dtype(np.float16): 2, np.dtype(np.uint8): 3,
            np.dtype(np.int32): 4, np.dtype(np.int8): 5,
            np.dtype(np.int64): 6, np.dtype(np.bool_): 7}
_DTYPE_OF = {v: k for k, v in _FLAG_OF.items()}

_KCPU = 1


def is_legacy_container(head: bytes) -> bool:
    return len(head) >= 8 and struct.unpack("<Q", head[:8])[0] == MAGIC_LIST


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated NDArray container")
        b = self.buf[self.pos: self.pos + n]
        self.pos += n
        return b

    def u32(self):
        return struct.unpack("<I", self._take(4))[0]

    def i32(self):
        return struct.unpack("<i", self._take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self._take(8))[0]

    def shape(self, ndim=None, dim_dtype="<i8"):
        if ndim is None:
            ndim = self.i32()
        itemsize = np.dtype(dim_dtype).itemsize
        return tuple(int(x) for x in
                     np.frombuffer(self._take(itemsize * ndim), dim_dtype))

    def data(self, flag, shape):
        dt = _DTYPE_OF[flag]
        n = int(np.prod(shape))
        return np.frombuffer(self._take(n * dt.itemsize), dt).reshape(shape)


def _shape_bytes(shape):
    return struct.pack("<i", len(shape)) + np.asarray(shape, "<i8").tobytes()


def _write_one(parts: List[bytes], a: np.ndarray) -> None:
    """One dense array as V2."""
    if a.dtype.name == "bfloat16" or a.dtype not in _FLAG_OF:
        a = a.astype(np.float32)
    parts.append(struct.pack("<Ii", _V2, 0))    # magic, kDefaultStorage
    parts.append(_shape_bytes(a.shape))
    parts.append(struct.pack("<iii", _KCPU, 0, _FLAG_OF[a.dtype]))
    parts.append(np.ascontiguousarray(a).tobytes())


def _read_one(r: _Reader) -> np.ndarray:
    magic = r.u32()
    if magic in (_V2, _V3):
        stype = r.i32()
        if stype != 0:
            raise ValueError("sparse storage type %d is not in the port"
                             % stype)
        shape = r.shape()
        if len(shape) == 0:
            return np.zeros((0,), np.float32)
        r.i32()  # dev_type
        r.i32()  # dev_id
        return r.data(r.i32(), shape)
    # legacy paths (ndarray.cc:1672 LegacyLoad)
    if magic == _V1:
        shape = r.shape()
    else:
        shape = r.shape(ndim=magic, dim_dtype="<u4")
    if len(shape) == 0:
        return np.zeros((0,), np.float32)
    r.i32()
    r.i32()
    return r.data(r.i32(), shape)


def save_legacy(arrays, names=None) -> bytes:
    """The container of ``arrays`` (numpy), named by ``names`` or not."""
    parts = [struct.pack("<QQQ", MAGIC_LIST, 0, len(arrays))]
    for a in arrays:
        _write_one(parts, np.asarray(a))
    names = names or []
    parts.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        parts.append(struct.pack("<Q", len(b)) + b)
    return b"".join(parts)


def load_legacy_buffer(buf: bytes):
    """``[numpy]`` or ``{name: numpy}``, as the file was written."""
    r = _Reader(buf)
    if r.u64() != MAGIC_LIST:
        raise ValueError("not an NDArray container (bad magic)")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_one(r) for _ in range(n)]
    n_names = r.u64()
    names = [r._take(r.u64()).decode() for _ in range(n_names)]
    if names:
        return dict(zip(names, arrays))
    return arrays
