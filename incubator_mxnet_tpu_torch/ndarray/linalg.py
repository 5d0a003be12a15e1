"""``mx.nd.linalg`` (port of ``incubator_mxnet_tpu/ndarray/linalg.py``):
each name runs the ``_linalg_`` op of ``ops/linalg.py`` on NDArrays,
recorded for autograd as every op is."""
from __future__ import annotations

from ..ops import linalg as _linalg  # noqa: F401  (registers the ops)
from ..ops import registry as _reg

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
           "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
           "extracttrian", "maketrian", "inverse", "det", "slogdet"]


def _make(opname):
    def fn(*inputs, **attrs):
        attrs.pop("name", None)
        return _reg.invoke(opname, list(inputs), **attrs)

    fn.__name__ = opname.replace("_linalg_", "")
    fn.__doc__ = _reg.get_op(opname).doc
    return fn


for _name in __all__:
    globals()[_name] = _make("_linalg_" + _name)
