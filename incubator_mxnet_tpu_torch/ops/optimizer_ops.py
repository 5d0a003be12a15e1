"""Optimizer update functions (port of ``incubator_mxnet_tpu/ops/
optimizer_ops.py``, the sgd family and the finiteness reduction).

MXNet's update form: ``g = grad * rescale_grad`` (clipped when
``clip_gradient >= 0``) ``+ wd * weight``; momentum accumulates
``momentum * mom - lr * g`` and the weight adds it.  ``torch.optim.SGD``
puts the learning rate and weight decay elsewhere, so it is not used.
Each function returns new tensors; the train step commits them.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "tree_all_finite"]


def _apply_wd(weight, grad, wd, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    g = _apply_wd(weight32, grad.float(), wd, rescale_grad, clip_gradient)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(weight32, grad.float(), wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


def tree_all_finite(leaves):
    """One boolean tensor, True iff every element of every floating leaf
    is finite.  It stays on the device: no host synchronisation."""
    flags = [torch.isfinite(a).all() for a in leaves if a.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()
