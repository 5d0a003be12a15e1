"""``mx.gluon.contrib`` (port of ``incubator_mxnet_tpu/gluon/contrib``):
``cnn`` (``DeformableConvolution``), ``data`` (``IntervalSampler``),
``estimator``, ``nn`` and ``rnn``."""
from . import cnn, data, estimator, nn, rnn

__all__ = ["cnn", "data", "estimator", "nn", "rnn"]
