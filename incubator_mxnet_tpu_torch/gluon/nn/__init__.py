"""Gluon's layers (``mx.gluon.nn``)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403

from .activations import __all__ as _act_all
from .basic_layers import __all__ as _basic_all
from .conv_layers import __all__ as _conv_all

__all__ = list(_basic_all) + list(_conv_all) + list(_act_all)
