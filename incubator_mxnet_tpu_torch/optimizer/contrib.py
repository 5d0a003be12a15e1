"""``mx.optimizer.contrib`` (port of ``incubator_mxnet_tpu/optimizer/
contrib.py``): ``GroupAdaGrad``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _clip, register

__all__ = ["GroupAdaGrad"]


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one learning rate per row (the embedding-table
    optimizer): the history accumulates each row's mean squared
    gradient.  Weight decay is refused, as in the reference::

        history += mean(square(grad), axis=1, keepdims=True)
        weight  -= lr * grad / sqrt(history + eps)
    """

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def _state(self, weight):
        if weight.dim() != 2:
            raise ValueError("GroupAdaGrad expects 2-D (row-grouped) "
                             "weights, got %r" % (tuple(weight.shape),))
        return torch.zeros((weight.shape[0], 1), dtype=weight.dtype,
                           device=weight.device)

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        if wd:
            raise ValueError("GroupAdaGrad does not support weight decay")
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        state = state + (g * g).mean(dim=1, keepdim=True)
        return weight - lr * g / torch.sqrt(state + self.float_stable_eps), \
            state
