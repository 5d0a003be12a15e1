"""``mx.contrib`` (port of ``incubator_mxnet_tpu/contrib``): int8 model
quantization (:mod:`.quantization`).  The reference's amp, onnx, text and
svrg subpackages are not ported yet (ROADMAP A13)."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
