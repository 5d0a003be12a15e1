"""``mx.image`` (port of ``incubator_mxnet_tpu/image``): image decode,
resize, crops and augmenters in numpy on the host, ``ImageIter`` and the
detection iterator ``ImageDetIter``."""
from .image import *  # noqa: F401,F403
from .image import __all__ as _img_all
from .detection import *  # noqa: F401,F403
from .detection import __all__ as _det_all

__all__ = list(_img_all) + list(_det_all)
