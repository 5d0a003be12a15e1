"""Optimizer update operators (port of ``incubator_mxnet_tpu/ops/
optimizer_ops.py``): the sgd family with its master-weight (``mp_``)
forms, ``nag_mom``, ``signsgd``, ``signum``, ``adam`` and ``mp_adam``,
``ftml``, ``rmsprop``, ``rmspropalex``, ``ftrl``, ``_sparse_adagrad``,
the two ``lamb`` phases, ``_adamw``, ``all_finite`` /
``multi_all_finite`` and the ``multi_*`` sgd forms, registered under the
reference's names (``nd.sgd_mom_update(...)``).

MXNet's update form: ``g = grad * rescale_grad`` (clipped when
``clip_gradient >= 0``) ``+ wd * weight``; momentum accumulates
``momentum * mom - lr * g`` and the weight adds it.  ``torch.optim``
puts the learning rate and weight decay elsewhere, so it is not used;
the reference computes these with XLA, not Pallas, so they are stock
torch ops.  Each function returns new tensors; the optimizer or the
train step commits them.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "mp_adam_update", "nag_mom_update",
           "signsgd_update", "signum_update", "adam_update", "ftml_update",
           "rmsprop_update", "rmspropalex_update", "ftrl_update",
           "adagrad_update", "lamb_update_phase1", "lamb_update_phase2",
           "adamw_update", "tree_all_finite"]


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(weight, grad, wd, rescale_grad, clip_gradient):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


@register("sgd_update", num_inputs=2, differentiable=False)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - lr * g


@register("sgd_mom_update", num_inputs=3, differentiable=False)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", num_inputs=3, differentiable=False)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(weight32, grad.float(), wd, rescale_grad, clip_gradient)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_inputs=4, differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _apply_wd(weight32, grad.float(), wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


@register("mp_adam_update", num_inputs=5, differentiable=False)
def mp_adam_update(weight, grad, mean, var, weight32, lr=0.001, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """Adam on the f32 master copy; only the committed weight is cast
    back."""
    g = _apply_wd(weight32, grad.float(), wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w32 = weight32 - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return w32.to(weight.dtype), new_mean, new_var, w32


@register("nag_mom_update", num_inputs=3, differentiable=False)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("signsgd_update", num_inputs=2, differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - lr * torch.sign(g)


@register("signum_update", num_inputs=3, differentiable=False)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    w = weight * (1 - lr * wd_lh) + lr * torch.sign(new_mom)
    return w, new_mom


@register("adam_update", num_inputs=4, differentiable=False)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return w, new_mean, new_var


def _f32_pow(base, t):
    """``base ** t`` in f32: the reference computes its bias corrections
    with ``t`` as an f32 array."""
    return torch.pow(torch.tensor(base, dtype=torch.float32),
                     torch.tensor(float(t), dtype=torch.float32))


@register("ftml_update", num_inputs=5, differentiable=False)
def ftml_update(weight, grad, d, v, z, lr=0.1, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    b1t = _f32_pow(beta1, t).to(weight.device)
    b2t = _f32_pow(beta2, t).to(weight.device)
    d_t = (1 - b1t) / lr * (torch.sqrt(new_v / (1 - b2t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    w = -new_z / d_t
    return w, d_t, new_v, new_z


@register("rmsprop_update", num_inputs=3, differentiable=False)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n


@register("rmspropalex_update", num_inputs=5, differentiable=False)
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_state
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n, new_g, new_delta


@register("ftrl_update", num_inputs=4, differentiable=False)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) > lamda1,
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd),
        torch.zeros((), dtype=weight.dtype, device=weight.device),
    ).to(weight.dtype)
    return w, new_z, new_n


@register("_sparse_adagrad_update", num_inputs=3, differentiable=False,
          aliases=("adagrad_update",))
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(weight, grad, wd, rescale_grad, clip_gradient)
    new_h = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_h) + epsilon), new_h


@register("lamb_update_phase1", num_inputs=4, differentiable=False)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mhat = new_mean / (1 - _f32_pow(beta1, t).to(weight.device))
        vhat = new_var / (1 - _f32_pow(beta2, t).to(weight.device))
    else:
        mhat, vhat = new_mean, new_var
    gw = mhat / (torch.sqrt(vhat) + epsilon) + wd * weight
    return gw, new_mean, new_var


@register("lamb_update_phase2", num_inputs=3, differentiable=False)
def lamb_update_phase2(weight, g, r1_r2=None, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    r1 = torch.linalg.vector_norm(weight.reshape(-1))
    r2 = torch.linalg.vector_norm(g.reshape(-1))
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return weight - lr * ratio * g


@register("_adamw_update", num_inputs=5, differentiable=False,
          aliases=("adamw_update",))
def adamw_update(weight, grad, mean, var, rescale_grad_arr, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    g = _clip(grad * rescale_grad_arr, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                        + wd * weight)
    return w, new_mean, new_var


def tree_all_finite(leaves):
    """One boolean tensor, True iff every element of every floating leaf
    is finite.  It stays on the device: no host synchronisation."""
    flags = [torch.isfinite(a).all() for a in leaves if a.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


@register("all_finite", differentiable=False)
def all_finite(*arrays, init_output=True):
    return tree_all_finite(arrays).reshape(1).to(torch.float32)


@register("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    return all_finite(*arrays)


def _multi(update_fn, n_per):
    def impl(*arrays, lrs=(), wds=(), num_weights=None, **kw):
        num = int(num_weights if num_weights is not None
                  else len(arrays) // n_per)
        outs = []
        for i in range(num):
            group = arrays[i * n_per:(i + 1) * n_per]
            res = update_fn(*group, lr=lrs[i], wd=wds[i], **kw)
            outs.extend(res if isinstance(res, tuple) else (res,))
        return tuple(outs) if len(outs) > 1 else outs[0]

    return impl


register("multi_sgd_update", _multi(sgd_update, 2), differentiable=False)
register("multi_sgd_mom_update", _multi(sgd_mom_update, 3),
         differentiable=False)
register("multi_mp_sgd_update", _multi(mp_sgd_update, 3),
         differentiable=False)
register("multi_mp_sgd_mom_update", _multi(mp_sgd_mom_update, 4),
         differentiable=False)
