"""Activation layers (port of ``incubator_mxnet_tpu/gluon/nn/
activations.py``): ``Activation``."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """``Activation(act_type)``: relu, sigmoid, tanh, softrelu or
    softsign (``ops.activation``)."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def _alias(self):
        # called by Block.__init__ before _act_type is set, as in the
        # reference: the prefix is "activation<N>_"
        return self._act_type if hasattr(self, "_act_type") \
            else "activation"

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Activation(x, act_type=self._act_type)
