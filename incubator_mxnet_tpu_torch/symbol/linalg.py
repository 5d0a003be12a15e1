"""``mx.sym.linalg`` (port of ``incubator_mxnet_tpu/symbol/linalg.py``):
each name composes a node of the ``_linalg_`` op of ``ops/linalg.py``."""
from __future__ import annotations

from ..ops import linalg as _linalg  # noqa: F401  (registers the ops)
from . import _invoke_symbol

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
           "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
           "extracttrian", "maketrian", "inverse", "det", "slogdet"]


def _make(opname):
    def fn(*inputs, name=None, **attrs):
        return _invoke_symbol(opname, list(inputs), attrs, name=name)

    fn.__name__ = opname.replace("_linalg_", "")
    return fn


for _name in __all__:
    globals()[_name] = _make("_linalg_" + _name)
