"""Neural-network operators of the vision zoo (port of
``incubator_mxnet_tpu/ops/nn.py``): convolution, pooling, fully
connected, activations, dropout, flatten, stock batch norm with its
running-stat update, and the ghost-BN ops with theirs.

Plain functions on tensors.  Convolution, the dense product and stock
batch norm are PyTorch's (XLA did them outside Pallas in the reference);
max pooling and ghost BN go through the port's kernels
(``parallel/maxpool_idx.py``, ``parallel/fused_bn.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import fused_bn, maxpool_idx

__all__ = ["convolution", "pooling", "fully_connected", "activation",
           "dropout", "flatten", "batch_norm", "batch_norm_stats",
           "batch_norm_aux_update", "ghost_bn_relu", "ghost_bn",
           "ghost_bn_add_relu", "ghost_bn_add_relu_dual",
           "ghost_bn_aux_update"]


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                dilate=(1, 1), num_group=1):
    """2-D NCHW convolution, weight (O, I / num_group, kh, kw)."""
    return F.conv2d(data, weight, bias, tuple(stride), tuple(pad),
                    tuple(dilate), int(num_group))


def _window_sum(data, kernel, stride, padding):
    """Sum over each window of ``data`` zero-padded by ``padding`` (the
    reference's ``reduce_window`` add): explicit padding, then windows
    that lie wholly inside the padded input."""
    xp = F.pad(data, (padding[1][0], padding[1][1], padding[0][0],
                      padding[0][1]))
    return F.avg_pool2d(xp, kernel, stride, divisor_override=1)


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True):
    """NCHW pooling (the reference's ``_pooling``): max, avg or sum,
    windowed or global.  ``pooling_convention="full"`` is ceil mode: the
    high edge is padded by ``pad + stride - 1``.  Windowed max pooling
    goes through the argmax-carrying forward of
    ``parallel/maxpool_idx.py`` (K3 on the card)."""
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=axes, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=axes, keepdim=True)
        raise ValueError("unknown pool_type %r" % (pool_type,))
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    if pooling_convention == "full":
        padding = tuple((p, p + s - 1) for p, s in zip(pad, stride))
    elif pooling_convention == "valid":
        padding = tuple((p, p) for p in pad)
    else:
        raise ValueError("unknown pooling_convention %r"
                         % (pooling_convention,))
    if pool_type == "max":
        return maxpool_idx.max_pool(data, (1, 1) + kernel, (1, 1) + stride,
                                    ((0, 0), (0, 0)) + padding)
    if pool_type in ("avg", "sum"):
        summed = _window_sum(data, kernel, stride, padding)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / math.prod(kernel)
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return summed / _window_sum(ones, kernel, stride, padding)
    raise ValueError("unknown pool_type %r" % (pool_type,))


def fully_connected(data, weight, bias=None):
    """``flatten(data) @ weight.T + bias``; weight (num_hidden, input_dim)."""
    return F.linear(flatten(data), weight, bias)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


def activation(data, act_type="relu"):
    """``Activation``: relu, sigmoid, tanh, softrelu (softplus) or
    softsign."""
    try:
        return _ACTIVATIONS[act_type](data)
    except KeyError:
        raise ValueError("unknown act_type %r" % (act_type,)) from None


def dropout(data, p=0.5, axes=(), training=True, generator=None):
    """``Dropout``: where the kept mask (drawn with probability ``1 - p``,
    one draw shared along ``axes``) holds, ``data / (1 - p)``, else 0.
    Identity for ``p <= 0`` and outside training.  ``generator`` defaults
    to the data's device generator of :mod:`..random` (seeded by
    ``random.seed``)."""
    if p <= 0 or not training:
        return data
    if generator is None:
        from .. import random

        generator = random.generator(data.device)
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


def flatten(data):
    return data.reshape(data.shape[0], -1)


def _channels_second(data, axis):
    axis = axis % data.dim()
    return (data, axis) if axis == 1 else (data.movedim(axis, 1), axis)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, use_global_stats=False, axis=1,
               training=True, output_mean_var=False):
    """``BatchNorm`` (the reference's ``_batch_norm``): normalize over
    every axis but ``axis``.  In training without ``use_global_stats`` the
    statistics are the batch's (biased variance, accumulated in f32), else
    the moving stats.  ``fix_gamma`` takes gamma as ones.  gamma and beta
    are widened to f32 (f64 for f64 data); the output is computed in that
    dtype and has the input's.  The op is pure: :func:`batch_norm_aux_update` moves the
    running stats.

    The batch form is ``torch.native_batch_norm`` with no running stats
    (cuDNN's counterpart on the card), which also returns the batch mean
    and ``1 / sqrt(var + eps)``: ``output_mean_var=True`` returns
    ``(out, mean, var)`` with those, f32."""
    x, axis = _channels_second(data, axis)
    c = x.shape[1]
    # f32, or f64 for f64 data
    cdt = torch.promote_types(x.dtype, torch.float32)
    g32 = torch.ones(c, dtype=cdt, device=x.device) if fix_gamma \
        else gamma.to(cdt)
    b32 = beta.to(cdt)
    if training and not use_global_stats:
        y, mean, rstd = torch.native_batch_norm(x, g32, b32, None, None, True,
                                                0.0, float(eps))
        var = (rstd.detach().pow(-2) - eps).clamp_min(0.0)
        mean = mean.detach()
    else:
        mean, var = moving_mean.to(cdt), moving_var.to(cdt)
        inv = torch.rsqrt(var + eps)
        bshape = (1, c) + (1,) * (x.dim() - 2)
        scale = (g32 * inv).reshape(bshape)
        shift = (b32 - mean * g32 * inv).reshape(bshape)
        y = (x.to(cdt) * scale + shift).to(x.dtype)
    if axis != 1:
        y = y.movedim(1, axis)
    return (y, mean, var) if output_mean_var else y


def batch_norm_stats(data, axis=1):
    """Batch mean and biased variance over every axis but ``axis``, in f32
    (the reference's ``_batch_norm_stats``: one pass, ``E[x^2] - E[x]^2``
    clamped at 0)."""
    x, _ = _channels_second(data, axis)
    red = (0,) + tuple(range(2, x.dim()))
    x = x.float()
    mean = x.mean(dim=red)
    var = (x.square().mean(dim=red) - mean.square()).clamp_min(0.0)
    return mean, var


def batch_norm_aux_update(old_mean, old_var, batch_mean, batch_var,
                          momentum=0.9):
    """Running-stat update of ``BatchNorm`` (the reference's
    ``_batch_norm_aux_update``): ``m * old + (1 - m) * batch`` in f32,
    cast back to the running stat's dtype.  MXNet's momentum weighs the
    old value; ``torch.nn.BatchNorm2d``'s weighs the new one."""
    return ghost_bn_aux_update(old_mean, old_var, batch_mean, batch_var,
                               momentum)


def _ghost_bn_common(data, residual, gamma, beta, moving_mean, moving_var,
                     eps, group, act, training, donate_residual=False,
                     dual_out=False):
    """Training: the fused kernels with group statistics, returning the
    merged batch stats for the running-average update.  Eval: normalize
    with the moving stats in plain torch.  gamma and beta are widened to
    f32 as in the reference."""
    g32 = gamma.float()
    b32 = beta.float()
    if training:
        outs = fused_bn.ghost_bn_act(data, g32, b32, residual=residual,
                                     eps=eps, act=act, group=group,
                                     donate_residual=donate_residual,
                                     dual_out=dual_out)
        bm, bv = fused_bn.ghost_bn_stats_merge(outs[-2], outs[-1])
        return outs[:-2] + (bm, bv)
    inv = torch.rsqrt(moving_var.float() + eps)
    scale = (g32 * inv).reshape(1, -1, 1, 1)
    shift = (b32 - moving_mean.float() * g32 * inv).reshape(1, -1, 1, 1)
    y = data.float() * scale + shift
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    y = y.to(data.dtype)
    outs = (y, y) if dual_out else (y,)
    return outs + (moving_mean.float(), moving_var.float())


def ghost_bn_relu(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                  group=0, training=True):
    """``_contrib_GhostBNReLU``: ``(out, batch_mean, batch_var)``."""
    return _ghost_bn_common(data, None, gamma, beta, moving_mean, moving_var,
                            float(eps), int(group), "relu", training)


def ghost_bn(data, gamma, beta, moving_mean, moving_var, eps=1e-3, group=0,
             training=True):
    """``_contrib_GhostBN``: ghost BN without activation (the downsample
    branch)."""
    return _ghost_bn_common(data, None, gamma, beta, moving_mean, moving_var,
                            float(eps), int(group), "none", training)


def ghost_bn_add_relu(data, residual, gamma, beta, moving_mean, moving_var,
                      eps=1e-3, group=0, donate_residual=False,
                      training=True):
    """``_contrib_GhostBNAddReLU``: the bottleneck exit."""
    return _ghost_bn_common(data, residual, gamma, beta, moving_mean,
                            moving_var, float(eps), int(group), "relu",
                            training, donate_residual=bool(donate_residual))


def ghost_bn_add_relu_dual(data, residual, gamma, beta, moving_mean,
                           moving_var, eps=1e-3, group=0,
                           donate_residual=False, training=True):
    """``_contrib_GhostBNAddReLUDual``: ``(out, out_sc, batch_mean,
    batch_var)``, the same output in two positions whose cotangents the
    backward kernel sums."""
    return _ghost_bn_common(data, residual, gamma, beta, moving_mean,
                            moving_var, float(eps), int(group), "relu",
                            training, donate_residual=bool(donate_residual),
                            dual_out=True)


def ghost_bn_aux_update(old_mean, old_var, batch_mean, batch_var,
                        momentum=0.9):
    """Running-stat update of the ghost-BN ops (ops/nn.py
    ``_ghost_bn_aux_update``): ``m * old + (1 - m) * batch`` in f32, cast
    back to the running stat's dtype."""
    m = float(momentum)
    return ((m * old_mean.float() + (1 - m) * batch_mean).to(old_mean.dtype),
            (m * old_var.float() + (1 - m) * batch_var).to(old_var.dtype))
