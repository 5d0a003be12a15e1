"""Neural-network operators of the ResNet path (port of
``incubator_mxnet_tpu/ops/nn.py``): convolution, pooling, fully connected,
activation, flatten and the ghost-BN ops with their running-stat update.

Plain functions on tensors.  Convolution and the dense product are
PyTorch's (XLA did them outside Pallas in the reference); max pooling and
ghost BN go through the port's kernels (``parallel/maxpool_idx.py``,
``parallel/fused_bn.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import fused_bn, maxpool_idx

__all__ = ["convolution", "pooling", "fully_connected", "activation",
           "flatten", "ghost_bn_relu", "ghost_bn", "ghost_bn_add_relu",
           "ghost_bn_add_relu_dual", "ghost_bn_aux_update"]


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0)):
    """2-D NCHW convolution, weight (O, I, kh, kw)."""
    return F.conv2d(data, weight, bias, tuple(stride), tuple(pad))


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None):
    """NCHW pooling: global average, or max with a window (through the
    argmax-carrying forward of ``parallel/maxpool_idx.py``).  The other
    pooling types wait for a later slice."""
    if global_pool and pool_type == "avg":
        return data.mean(dim=(2, 3), keepdim=True)
    if global_pool or pool_type != "max":
        raise NotImplementedError("%s%s pooling is not in the port yet"
                                  % ("global " if global_pool else "",
                                     pool_type))
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    padding = ((0, 0), (0, 0)) + tuple((p, p) for p in pad)
    return maxpool_idx.max_pool(data, (1, 1) + kernel, (1, 1) + stride,
                                padding)


def fully_connected(data, weight, bias=None):
    """``flatten(data) @ weight.T + bias``; weight (num_hidden, input_dim)."""
    return F.linear(flatten(data), weight, bias)


def activation(data, act_type="relu"):
    if act_type != "relu":
        raise NotImplementedError("activation %r is not in the port yet"
                                  % (act_type,))
    return torch.relu(data)


def flatten(data):
    return data.reshape(data.shape[0], -1)


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
