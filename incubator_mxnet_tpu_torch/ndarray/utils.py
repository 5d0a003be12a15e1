"""``nd.save``/``nd.load`` (port of ``incubator_mxnet_tpu/ndarray/utils.py``,
the reference's ``.params`` format).

A file holds a list of arrays or a dict of named ones, in the stock MXNet
container (:mod:`.legacy_io`), so files cross between the JAX package and
the port byte for byte.  ``save`` writes a temporary file beside the
target and renames it, so an interrupted save never leaves a torn file.
The reference's second format, ``npz``, is not ported.
"""
from __future__ import annotations

import os
import tempfile

from . import legacy_io
from .ndarray import NDArray, array

__all__ = ["save", "load", "load_frombuffer"]


def _atomic_write(fname: str, buf: bytes) -> None:
    d = os.path.dirname(os.path.abspath(fname)) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(fname) + ".",
                               suffix=".tmp", dir=d)
    try:
        # mkstemp makes the file 0600; give it what open() would
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, "wb") as f:
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(fname: str, data) -> None:
    """Save an NDArray, a list of them or a dict of named ones."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = list(data.values())
    elif isinstance(data, (list, tuple)):
        names = None
        arrays = list(data)
    else:
        raise ValueError("data must be NDArray, list of NDArrays, or dict")
    _atomic_write(fname, legacy_io.save_legacy(
        [a.asnumpy() for a in arrays], names))


def load_frombuffer(buf: bytes, ctx=None):
    """The arrays of a ``.params`` buffer, on ``ctx`` (``None``: the
    default CUDA card)."""
    if not legacy_io.is_legacy_container(bytes(buf[:8])):
        raise ValueError("not an MXNet .params container")
    out = legacy_io.load_legacy_buffer(bytes(buf))
    if isinstance(out, dict):
        return {k: array(v, ctx) for k, v in out.items()}
    return [array(v, ctx) for v in out]


def load(fname: str, ctx=None):
    """The arrays of a ``.params`` file, as a list or a dict, on ``ctx``
    (``None``: the default CUDA card)."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), ctx)
