"""Activation layers (port of ``incubator_mxnet_tpu/gluon/nn/
activations.py``): ``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``,
``SELU``, ``GELU`` and ``Swish``, whose bodies are the reference's
(the ``LeakyReLU`` op's act types, ``sigmoid``)."""
from __future__ import annotations

from ... import context, initializer
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


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


class LeakyReLU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of shape (1,) (0.25 by
    default), on ``device``."""

    def __init__(self, alpha_initializer=None, device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):  # noqa: N803
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):  # noqa: N803
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """GELU in its erf form."""

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):  # noqa: N803
        return x * F.sigmoid(self._beta * x)
