"""``mx.sym.contrib`` (port of ``incubator_mxnet_tpu/symbol/contrib.py``'s
name resolution): ``mx.sym.contrib.<name>`` composes a node of the
``_contrib_<name>`` op (or of ``<name>``), as ``mx.sym.<name>`` does.

The reference's symbolic control flow (``foreach``, ``while_loop``,
``cond``: subgraphs stored as node attributes) is not ported yet: those
names raise, naming ROADMAP Queue A item 2b.
"""
from __future__ import annotations

import sys

from ..ops import registry as _reg

__all__ = []

_CONTROL_FLOW = ("foreach", "while_loop", "cond")


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in _CONTROL_FLOW:
        raise AttributeError(
            "mx.sym.contrib.%s (symbolic control flow) is not in the port "
            "yet: ROADMAP Queue A item 2b; the eager form is "
            "mx.nd.contrib.%s" % (name, name))
    from . import _make_wrapper

    for cand in ("_contrib_" + name, name):
        if cand in _reg.OPS:
            w = _make_wrapper(name, _reg.OPS[cand])
            setattr(sys.modules[__name__], name, w)
            return w
    raise AttributeError("mx.sym.contrib has no operator %r" % name)
