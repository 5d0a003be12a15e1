"""Misc utilities (port of ``incubator_mxnet_tpu/util.py``): the
NumPy-shape and NumPy-array semantics switches (per thread), their
scopes and decorator, environment helpers and the data directory."""
from __future__ import annotations

import functools
import os
import threading

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "np_array",
           "np_shape", "use_np", "getenv", "setenv", "makedirs", "data_dir"]


def data_dir() -> str:
    """The data and cache root: ``$MXNET_HOME`` if set, else
    ``~/.mxnet``."""
    return os.environ.get("MXNET_HOME") or os.path.join(
        os.path.expanduser("~"), ".mxnet")


_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "np_array"):
        _STATE.np_array = False
        _STATE.np_shape = False
    return _STATE


def is_np_array():
    return _st().np_array


def is_np_shape():
    return _st().np_shape


def set_np(shape=True, array=True):
    s = _st()
    s.np_shape = shape
    s.np_array = array


def reset_np():
    set_np(False, False)


class _NpScope:
    def __init__(self, shape=None, array=None):
        self._shape = shape
        self._array = array

    def __enter__(self):
        s = _st()
        self._prev = (s.np_shape, s.np_array)
        if self._shape is not None:
            s.np_shape = self._shape
        if self._array is not None:
            s.np_array = self._array
        return self

    def __exit__(self, *exc):
        s = _st()
        s.np_shape, s.np_array = self._prev


def np_shape(active=True):
    return _NpScope(shape=active)


def np_array(active=True):
    return _NpScope(array=active)


def use_np(func):
    """Run ``func`` with both NumPy semantics on."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with _NpScope(shape=True, array=True):
            return func(*args, **kwargs)

    return wrapper


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value


def makedirs(d):
    os.makedirs(d, exist_ok=True)
