"""``mx.contrib`` (port of ``incubator_mxnet_tpu/contrib``): automatic
mixed precision (:mod:`.amp`) and int8 model quantization
(:mod:`.quantization`).  The reference's onnx, text and svrg subpackages
are not ported yet (ROADMAP A13)."""
from . import amp  # noqa: F401
from . import quantization  # noqa: F401

__all__ = ["amp", "quantization"]
