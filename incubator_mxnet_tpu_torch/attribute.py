"""Attribute scopes for symbol composition (port of
``incubator_mxnet_tpu/attribute.py``, ``python/mxnet/attribute.py``).

The port keeps its own copy.  Inside ``with AttrScope(ctx_group="a")``
every variable made gets those attributes (``Symbol.attr``); nested
scopes merge, the inner one winning.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    _state = threading.local()

    def __init__(self, **kwargs):
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr=None):
        """The scope's attributes updated by ``attr``."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._state.value = self
        return self

    def __exit__(self, *exc):
        AttrScope._state.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._state, "value"):
            AttrScope._state.value = AttrScope()
        return AttrScope._state.value


def current():
    return AttrScope.current()
