"""The Estimator (port of
``incubator_mxnet_tpu/gluon/contrib/estimator``): ``Estimator``'s
``fit``/``evaluate`` loop, ``BatchProcessor`` and the event handlers."""
from .batch_processor import BatchProcessor
from .estimator import Estimator
from .event_handler import *  # noqa: F401,F403
from . import event_handler
