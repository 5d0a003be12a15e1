"""``mx.optimizer`` (port of ``incubator_mxnet_tpu/optimizer``): the
registered optimizers, ``Updater`` and ``contrib.GroupAdaGrad``."""
from . import contrib
from .contrib import GroupAdaGrad
from .optimizer import *  # noqa: F401,F403
from .optimizer import __all__ as _opt_all

__all__ = list(_opt_all) + ["GroupAdaGrad", "contrib"]
