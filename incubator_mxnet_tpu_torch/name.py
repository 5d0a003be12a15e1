"""Automatic symbol naming (port of ``incubator_mxnet_tpu/name.py``,
``python/mxnet/name.py``'s ``NameManager`` and ``Prefix``).

The port keeps its own copy: it never imports the JAX package.  A
``NameManager`` hands out ``<hint><n>`` names, one counter per hint; the
innermost ``with`` scope of this thread is current.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _state = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._state.value = self
        return self

    def __exit__(self, *exc):
        NameManager._state.value = self._old_manager

    @staticmethod
    def current():
        if not hasattr(NameManager._state, "value"):
            NameManager._state.value = NameManager()
        return NameManager._state.value


class Prefix(NameManager):
    """Prefixes every name it hands out with ``prefix``."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
