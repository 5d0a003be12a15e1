"""Neural-network operators (port of ``incubator_mxnet_tpu/ops/nn.py``):
convolution and transposed convolution, pooling over 1 to 3 spatial
axes, fully connected, activations, dropout, flatten, stock batch norm
with its running-stat update, the ghost-BN ops with theirs, the layer,
group and instance norms, L2 normalization, LRN, ``LeakyReLU``, the
resizes, adaptive average pooling and CTC loss.

Plain functions on tensors.  Convolutions, the dense product, stock
batch norm and the rest are PyTorch's (XLA did them outside Pallas in
the reference); 2-D max pooling and ghost BN go through the port's
kernels (``parallel/maxpool_idx.py``, ``parallel/fused_bn.py``).

The registry forms that ``sym.*`` and ``nd.*`` call by name keep the
reference's signatures: the same inputs in the same order, then the same
attributes with the same defaults (the reference's PRNG ``key`` aside:
Dropout and rrelu draw from the port's generator).  Their training mode
is ``autograd.is_training()``, which the symbolic executor sets for its
forward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import collectives, fused_bn, maxpool_idx
from .registry import register

__all__ = ["convolution", "deconvolution", "pooling", "fully_connected",
           "activation", "dropout", "flatten", "batch_norm",
           "batch_norm_stats", "batch_norm_aux_update", "ghost_bn_relu",
           "ghost_bn", "ghost_bn_add_relu", "ghost_bn_add_relu_dual",
           "ghost_bn_nostats", "ghost_bn_aux_update", "leaky_relu",
           "resize_bilinear", "ctc_forward"]


_CONV = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                dilate=(1, 1), num_group=1):
    """NC(D)(H)W convolution over 1 to 3 spatial axes, weight (O, I /
    num_group, k...)."""
    return _CONV[data.dim()](data, weight, bias, tuple(stride), tuple(pad),
                             tuple(dilate), int(num_group))


_CONV_T = {3: F.conv_transpose1d, 4: F.conv_transpose2d,
           5: F.conv_transpose3d}


def deconvolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                  dilate=(1, 1), adj=(0, 0), num_group=1):
    """The reference's ``Deconvolution`` over 1 to 3 spatial axes: the
    transposed convolution of weight (in, out / num_group, k...), ``adj``
    padding the high edge.  With ``num_group > 1`` the reference neither
    flips nor regroups the weight: it runs a grouped forward convolution
    of the stride-dilated input with the weight as it is, taken as
    (out, in / num_group, k...), and so does the port (ROADMAP Queue C);
    a weight of another width raises ``ValueError`` there as here."""
    stride, pad, dilate, adj = (tuple(int(v) for v in t)
                                for t in (stride, pad, dilate, adj))
    num_group = int(num_group)
    if num_group == 1 and all(a < max(s, d) for a, s, d
                              in zip(adj, stride, dilate)):
        return _CONV_T[data.dim()](data, weight, bias, stride, pad, adj, 1,
                                   dilate)
    if num_group == 1:
        weight = torch.flip(weight, dims=tuple(range(2, weight.dim())))
        weight = weight.transpose(0, 1)
    elif weight.shape[1] * num_group != data.shape[1]:
        raise ValueError(
            "Deconvolution with num_group=%d convolves the weight as it is: "
            "its axis 1 (%d) times the groups must equal the input's %d "
            "channels" % (num_group, weight.shape[1], data.shape[1]))
    # the input dilated by the stride, padded by d * (k - 1) - p (and
    # adj on the high edge; a negative pad crops), then convolved
    n, c = data.shape[:2]
    spatial = data.shape[2:]
    dil = data.new_zeros((n, c) + tuple((i - 1) * s + 1
                                         for i, s in zip(spatial, stride)))
    dil[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                           for s in stride)] = data
    pads = []
    for k, p, d, a in reversed(list(zip(weight.shape[2:], pad, dilate,
                                        adj))):
        pads += [d * (k - 1) - p, d * (k - 1) - p + a]
    return _CONV[data.dim()](F.pad(dil, pads), weight, bias, 1, 0, dilate,
                             num_group)


def _pad_spatial(data, padding, value=0.0):
    """``data`` padded on its spatial axes by ``padding``, one (low, high)
    pair an axis."""
    flat = []
    for lo, hi in reversed(padding):
        flat += [lo, hi]
    return F.pad(data, flat, value=value)


def _window_sum(data, kernel, stride, padding):
    """Sum over each window of ``data`` zero-padded by ``padding`` (the
    reference's ``reduce_window`` add) over 1 to 3 spatial axes: explicit
    padding, then windows that lie wholly inside the padded input."""
    xp = _pad_spatial(data, padding)
    if len(kernel) == 1:
        return F.avg_pool2d(xp.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(xp, kernel, stride, divisor_override=1)


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True, p_value=2):
    """NC(D)(H)W pooling over 1 to 3 spatial axes (the reference's
    ``_pooling``): max, avg, sum or lp (the ``p_value``-norm of each
    window), windowed or global.  ``pooling_convention="full"`` is ceil
    mode: the high edge is padded by ``pad + stride - 1``.  Windowed 2-D
    max pooling goes through ``maxpool_idx.max_pool``: K3 on the card
    where the reference places its indexed kernel; 1-D and 3-D max
    pooling (no Pallas kernel in the reference) is ``F.max_pool1d`` /
    ``F.max_pool3d`` over the input padded with -inf."""
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=axes, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=axes, keepdim=True)
        if pool_type == "lp":
            return data.abs().pow(p_value).sum(dim=axes, keepdim=True) \
                .pow(1.0 / p_value)
        raise ValueError("unknown pool_type %r" % (pool_type,))
    kernel = tuple(kernel)
    nsp = len(kernel)
    stride = tuple(stride) if stride else (1,) * nsp
    pad = tuple(pad) if pad else (0,) * nsp
    if pooling_convention == "full":
        padding = tuple((p, p + s - 1) for p, s in zip(pad, stride))
    elif pooling_convention == "valid":
        padding = tuple((p, p) for p in pad)
    else:
        raise ValueError("unknown pooling_convention %r"
                         % (pooling_convention,))
    if pool_type == "max" and nsp == 2:
        return maxpool_idx.max_pool(data, (1, 1) + kernel, (1, 1) + stride,
                                    ((0, 0), (0, 0)) + padding)
    if pool_type == "max":
        low = -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        pool = F.max_pool1d if nsp == 1 else F.max_pool3d
        return pool(_pad_spatial(data, padding, low), kernel, stride)
    if pool_type in ("avg", "sum"):
        summed = _window_sum(data, kernel, stride, padding)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / math.prod(kernel)
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return summed / _window_sum(ones, kernel, stride, padding)
    if pool_type == "lp":
        return _window_sum(data.abs().pow(p_value), kernel, stride,
                           padding).pow(1.0 / p_value)
    raise ValueError("unknown pool_type %r" % (pool_type,))


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias`` over the last axis, ``data`` flattened
    to (N, -1) first when ``flatten``; weight (num_hidden, input_dim)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, bias)


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
    if generator is None and data.device.type != "meta":
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
    dp = collectives.current_dp()
    if training and not use_global_stats and dp is not None:
        y, mean, var = _SyncBatchNorm.apply(x, g32, b32, float(eps), dp)
    elif training and not use_global_stats:
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


class _SyncBatchNorm(torch.autograd.Function):
    """Training batch norm of one rank of a data-parallel step, with the
    statistics of the whole global batch, as the reference's
    ``_batch_norm`` takes them over a dp-sharded batch.

    Forward: each rank's (count, mean, M2), its moments from
    ``torch.native_batch_norm`` (as the one-process path takes them),
    gathered over the dp axis and merged in rank order by Chan's formula,
    so every rank normalizes with the same bits; then one
    ``native_batch_norm`` pass with the merged statistics.  Backward: the
    eval-mode backward at those statistics gives Sigma dy and Sigma
    dy*xhat, summed over the axis in one ``all_reduce``, and the terms
    of dx they weigh; dgamma and dbeta stay this rank's (the step
    averages the gradients).  Returns ``(y, mean, biased var)`` in
    gamma's dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, dp):
        count = x.numel() // x.shape[1]
        _, mean, invstd = torch.native_batch_norm(x, None, None, None, None,
                                                  True, 0.0, eps)
        mean = mean.to(gamma.dtype)
        m2 = (invstd.to(gamma.dtype).pow(-2) - eps).clamp_min(0.0) * count
        local = torch.stack([torch.full_like(mean, count), mean, m2])
        every = collectives.allgather(local, dp.axis_name, dp.mesh, axis=0,
                                      tiled=False)
        n, mean, m2 = every[0, 0], every[0, 1], every[0, 2]
        for r in range(1, every.shape[0]):
            nr, mr, m2r = every[r, 0], every[r, 1], every[r, 2]
            tot = n + nr
            delta = mr - mean
            mean = mean + delta * (nr / tot)
            m2 = m2 + m2r + delta.square() * (n * nr / tot)
            n = tot
        var = m2 / n
        y = torch.native_batch_norm(x, gamma, beta, mean, var, False, 0.0,
                                    eps)[0]
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.dp, ctx.total, ctx.eps = dp, n, eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, var = ctx.saved_tensors
        dp = ctx.dp
        bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        dx_eval, dgamma, dbeta = torch.ops.aten.native_batch_norm_backward(
            dy.contiguous(), x, gamma, mean, var, None, None, False, ctx.eps,
            [True, True, True])
        s_dy, s_dyx = collectives.allreduce_coalesced(
            [dbeta, dgamma], dp.axis_name, dp.mesh)
        # dx = g*invstd*(dy - S_dy/N - xhat*S_dyxhat/N): the eval backward
        # gave g*invstd*dy; the rest is a + b*x per channel
        invstd = torch.rsqrt(var + ctx.eps)
        b = -gamma * invstd * invstd * s_dyx / ctx.total
        a = -gamma * invstd * s_dy / ctx.total - b * mean
        dx = torch.addcmul(a.reshape(bshape), x, b.reshape(bshape))
        return (dx + dx_eval).to(x.dtype), dgamma, dbeta, None, None


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


def _global_batch(data):
    """The batch a ghost group is picked for: inside a data-parallel step
    (``collectives.dp_scope``) the global batch, of which ``data`` is one
    rank's equal slice, as the reference's op sees it."""
    dp = collectives.current_dp()
    return data.shape[0] * (dp.size if dp is not None else 1)


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
                                     dual_out=dual_out,
                                     batch=_global_batch(data))
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


def ghost_bn_nostats(data, gamma, beta, eps=1e-3, group=0, act="relu"):
    """``_contrib_GhostBNReLUNS`` (``act="relu"``) and ``_contrib_GhostBNNS``
    (``act="none"``): ghost BN with no running stats, normalized by the
    ghost groups' statistics in every mode (the reference's pipelined
    form), through the fused kernels."""
    return fused_bn.ghost_bn_act(data, gamma.float(), beta.float(),
                                 eps=float(eps), act=act, group=int(group),
                                 batch=_global_batch(data))[0]


def ghost_bn_aux_update(old_mean, old_var, batch_mean, batch_var,
                        momentum=0.9):
    """Running-stat update of the ghost-BN ops (ops/nn.py
    ``_ghost_bn_aux_update``): ``m * old + (1 - m) * batch`` in f32, cast
    back to the running stat's dtype."""
    m = float(momentum)
    return ((m * old_mean.float() + (1 - m) * batch_mean).to(old_mean.dtype),
            (m * old_var.float() + (1 - m) * batch_var).to(old_var.dtype))


# ---------------------------------------------------------------------------
# registry forms (the reference's ops/nn.py registrations)
# ---------------------------------------------------------------------------


def _is_train():
    from .. import autograd

    return autograd.is_training()


@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected_op(data, weight, bias=None, num_hidden=None,
                        no_bias=False, flatten=True):
    return fully_connected(data, weight, None if no_bias else bias, flatten)


@register("Convolution", aliases=("conv",))
def _convolution_op(data, weight, bias=None, kernel=None, stride=None,
                    dilate=None, pad=None, num_filter=None, num_group=1,
                    workspace=1024, no_bias=False, cudnn_tune=None,
                    cudnn_off=False, layout=None):
    if layout is not None and not layout.startswith("NC"):
        raise NotImplementedError("Convolution takes NC* layouts, got %r"
                                  % (layout,))
    nspatial = data.dim() - 2
    return convolution(data, weight, None if no_bias else bias,
                       stride or (1,) * nspatial, pad or (0,) * nspatial,
                       dilate or (1,) * nspatial, num_group)


@register("Pooling", aliases=("pool",))
def _pooling_op(data, kernel=None, pool_type="max", global_pool=False,
                cudnn_off=False, pooling_convention="valid", stride=None,
                pad=None, p_value=2, count_include_pad=True, layout=None):
    return pooling(data, kernel, pool_type, global_pool, pooling_convention,
                   stride, pad, count_include_pad, p_value)


def _batch_norm_aux_update(in_vals, out_vals, momentum=0.9, axis=1,
                           use_global_stats=False, **_):
    """BatchNorm's running stats (inputs 3 and 4) after a training
    forward (the reference's ``_batch_norm_aux_update``): the one-pass
    batch statistics of :func:`batch_norm_stats`, MXNet's momentum."""
    if use_global_stats and str(use_global_stats).lower() != "false":
        return {}
    mean, var = batch_norm_stats(in_vals[0], axis=int(axis))
    new_m, new_v = batch_norm_aux_update(in_vals[3], in_vals[4], mean, var,
                                         momentum)
    return {3: new_m, 4: new_v}


@register("BatchNorm", aliases=("batch_norm",),
          aux_update=_batch_norm_aux_update, mutate_idx=(3, 4))
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False):
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                      fix_gamma, use_global_stats, axis, _is_train(),
                      output_mean_var)


def _ghost_bn_aux_update_op(in_vals, out_vals, momentum=0.9, **_):
    """The ghost-BN ops' running stats (inputs 3 and 4, or 4 and 5 with a
    residual) from the batch statistics the forward returned (the
    reference's ``_ghost_bn_aux_update``)."""
    base = 3 if len(in_vals) == 5 else 4
    new_m, new_v = ghost_bn_aux_update(in_vals[base], in_vals[base + 1],
                                       out_vals[1], out_vals[2], momentum)
    return {base: new_m, base + 1: new_v}


def _ghost_bn_aux_update_dual(in_vals, out_vals, momentum=0.9, **_):
    """The dual form's outputs are (out, out_sc, mean, var): drop out_sc."""
    return _ghost_bn_aux_update_op(in_vals, (out_vals[0],) + tuple(
        out_vals[2:]), momentum=momentum)


@register("_contrib_GhostBNReLU", num_inputs=5, num_outputs=3,
          mutate_idx=(3, 4), aux_update=_ghost_bn_aux_update_op)
def _ghost_bn_relu_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                      momentum=0.9, group=0):
    """Ghost BN + ReLU: ``(out, batch_mean, batch_var)``; K1 (K2 on
    backward) in training, the moving stats in plain torch otherwise."""
    return ghost_bn_relu(data, gamma, beta, moving_mean, moving_var, eps,
                         group, _is_train())


@register("_contrib_GhostBNAddReLU", num_inputs=6, num_outputs=3,
          mutate_idx=(4, 5), aux_update=_ghost_bn_aux_update_op)
def _ghost_bn_add_relu_op(data, residual, gamma, beta, moving_mean,
                          moving_var, eps=1e-3, momentum=0.9, group=0,
                          donate_residual=0):
    """Ghost BN + residual add + ReLU (the bottleneck exit).
    ``donate_residual`` takes part in the group choice only (the
    ``GhostBNReLU`` layer's note)."""
    return ghost_bn_add_relu(data, residual, gamma, beta, moving_mean,
                             moving_var, eps, group,
                             bool(int(donate_residual)), _is_train())


@register("_contrib_GhostBNAddReLUDual", num_inputs=6, num_outputs=4,
          mutate_idx=(4, 5), aux_update=_ghost_bn_aux_update_dual)
def _ghost_bn_add_relu_dual_op(data, residual, gamma, beta, moving_mean,
                               moving_var, eps=1e-3, momentum=0.9, group=0,
                               donate_residual=0):
    """The dual exit: ``(out, out_sc, batch_mean, batch_var)``, two graph
    entries whose cotangents K2 takes apart and sums on load."""
    return ghost_bn_add_relu_dual(data, residual, gamma, beta, moving_mean,
                                  moving_var, eps, group,
                                  bool(int(donate_residual)), _is_train())


@register("_contrib_GhostBN", num_inputs=5, num_outputs=3,
          mutate_idx=(3, 4), aux_update=_ghost_bn_aux_update_op)
def _ghost_bn_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                 momentum=0.9, group=0):
    """Ghost BN without activation (the downsample branch)."""
    return ghost_bn(data, gamma, beta, moving_mean, moving_var, eps, group,
                    _is_train())


@register("_contrib_GhostBNReLUNS", num_inputs=3)
def _ghost_bn_relu_nostats_op(data, gamma, beta, eps=1e-3, group=0):
    """Stats-free ghost BN + ReLU: ghost statistics in every mode, no aux
    state."""
    return ghost_bn_nostats(data, gamma, beta, eps, group, "relu")


@register("_contrib_GhostBNNS", num_inputs=3)
def _ghost_bn_nostats_op(data, gamma, beta, eps=1e-3, group=0):
    """Stats-free ghost BN without activation."""
    return ghost_bn_nostats(data, gamma, beta, eps, group, "none")


@register("Activation", num_inputs=1)
def _activation_op(data, act_type="relu"):
    return activation(data, act_type)


@register("Dropout", num_inputs=1)
def _dropout_op(data, p=0.5, mode="training", axes=(), cudnn_off=False):
    return dropout(data, p, axes, training=mode == "always" or _is_train())


def _softmax_fwd(d, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(d, dim=1)
    if preserve_shape:
        return torch.softmax(d, dim=-1)
    return torch.softmax(d.reshape(d.shape[0], -1), dim=-1).reshape(d.shape)


def _soft_onehot(label, k, dtype, smooth_alpha):
    """One-hot rows of ``label`` over ``k`` classes (all zero for a label
    out of range), smoothed by ``smooth_alpha``."""
    oh = (label.to(torch.long)[..., None]
          == torch.arange(k, device=label.device)).to(dtype)
    if smooth_alpha:
        oh = oh * (1.0 - smooth_alpha) + smooth_alpha / (k - 1) * (1.0 - oh)
    return oh


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward ``(p - onehot(label)) * grad_scale``
    (the reference's custom VJP, ``softmax_output.cc``), ignoring the
    head gradient unless ``out_grad``."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        out = _softmax_fwd(data, cfg["multi_output"], cfg["preserve_shape"])
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        cfg = ctx.cfg
        ignore = label != cfg["ignore_label"]
        if cfg["multi_output"]:
            oh = _soft_onehot(label, out.shape[1], out.dtype, 0.0)
            grad = out - oh.movedim(-1, 1)
            if cfg["use_ignore"]:
                grad = grad * ignore.to(out.dtype).unsqueeze(1)
        elif cfg["preserve_shape"]:
            grad = out - _soft_onehot(label, out.shape[-1], out.dtype,
                                      cfg["smooth_alpha"])
            if cfg["use_ignore"]:
                grad = grad * ignore.to(out.dtype)[..., None]
        else:
            flat = out.reshape(out.shape[0], -1)
            grad = (flat - _soft_onehot(label.reshape(-1), flat.shape[-1],
                                        out.dtype, cfg["smooth_alpha"])
                    ).reshape(out.shape)
            if cfg["use_ignore"]:
                grad = grad * ignore.reshape(-1).to(out.dtype).reshape(
                    (-1,) + (1,) * (grad.dim() - 1))
        scale = cfg["grad_scale"]
        if cfg["normalization"] == "batch":
            scale = scale / out.shape[0]
        elif cfg["normalization"] == "valid" and cfg["use_ignore"]:
            scale = scale / ignore.to(out.dtype).sum().clamp_min(1.0)
        grad = grad * scale
        if cfg["out_grad"]:
            grad = grad * g
        return grad, None, None


@register("SoftmaxOutput", num_inputs=2, aliases=("Softmax", "softmax_output"))
def _softmax_output_op(data, label, grad_scale=1.0, ignore_label=-1.0,
                       multi_output=False, use_ignore=False,
                       preserve_shape=False, normalization="null",
                       out_grad=False, smooth_alpha=0.0):
    cfg = dict(grad_scale=grad_scale, ignore_label=ignore_label,
               multi_output=multi_output, use_ignore=use_ignore,
               preserve_shape=preserve_shape, normalization=normalization,
               out_grad=out_grad, smooth_alpha=smooth_alpha)
    return _SoftmaxOutput.apply(data, label, cfg)


# ---------------------------------------------------------------------------
# the rest of the reference's nn.py: Deconvolution, batch_norm_stats, the
# norms, LeakyReLU, SoftmaxActivation, the resizes, adaptive pooling and
# CTC loss (all computed outside Pallas in the reference: torch ops here)
# ---------------------------------------------------------------------------


@register("Deconvolution", aliases=("deconv",))
def _deconvolution_op(data, weight, bias=None, kernel=None, stride=None,
                      dilate=None, pad=None, adj=None, target_shape=None,
                      num_filter=None, num_group=1, workspace=512,
                      no_bias=True, cudnn_tune=None, cudnn_off=False,
                      layout=None):
    if layout is not None and not layout.startswith("NC"):
        raise NotImplementedError("Deconvolution takes NC* layouts, got %r"
                                  % (layout,))
    nsp = data.dim() - 2
    return deconvolution(data, weight, None if no_bias else bias,
                         stride or (1,) * nsp, pad or (0,) * nsp,
                         dilate or (1,) * nsp, adj or (0,) * nsp, num_group)


@register("batch_norm_stats", num_inputs=1, num_outputs=2,
          differentiable=False)
def _batch_norm_stats_op(data, axis=1):
    return batch_norm_stats(data, int(axis))


def _bshape(data, axis):
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return shape


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalize over ``axis`` in f32, cast back; ``output_mean_var`` also
    returns the mean and ``1 / sqrt(var + eps)``, f32, as the
    reference."""
    x = data.to(torch.float32)
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps)
    shape = _bshape(data, axis)
    out = ((x - mean) * inv * gamma.to(torch.float32).reshape(shape)
           + beta.to(torch.float32).reshape(shape)).to(data.dtype)
    if output_mean_var:
        return out, mean.squeeze(axis), inv.squeeze(axis)
    return out


@register("GroupNorm", aliases=("group_norm",))
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
                output_mean_var=False):
    """Normalize each of ``num_groups`` channel groups of each sample in
    f32, cast back; ``output_mean_var`` also returns the mean and the
    variance, (N, groups), as the reference."""
    n, c = data.shape[:2]
    g = int(num_groups)
    x = data.reshape((n, g, c // g) + tuple(data.shape[2:])).to(
        torch.float32)
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, keepdim=True, correction=0)
    norm = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, c) + (1,) * (data.dim() - 2)
    out = (norm * gamma.to(torch.float32).reshape(shape)
           + beta.to(torch.float32).reshape(shape)).to(data.dtype)
    if output_mean_var:
        return out, mean.reshape(n, g), var.reshape(n, g)
    return out


@register("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Normalize each channel of each sample in f32; gamma and beta keep
    their dtype (the reference does not widen them), the result has the
    data's."""
    x = data.to(torch.float32)
    red = tuple(range(2, data.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, keepdim=True, correction=0)
    shape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape)).to(data.dtype)


@register("L2Normalization", aliases=("l2_normalization",), num_inputs=1)
def _l2_normalization(data, eps=1e-10, mode="instance"):
    x = data.to(torch.float32)
    if mode == "instance":
        norm = x.reshape(x.shape[0], -1).square().sum(dim=1).sqrt()
        norm = norm.reshape((-1,) + (1,) * (data.dim() - 1))
    elif mode == "channel":
        norm = x.square().sum(dim=1, keepdim=True).sqrt()
    elif mode == "spatial":
        norm = x.reshape(x.shape[0], x.shape[1], -1).square().sum(
            dim=2).sqrt().reshape(tuple(x.shape[:2])
                                  + (1,) * (data.dim() - 2))
    else:
        raise ValueError(mode)
    return (x / (norm + eps)).to(data.dtype)


@register("LRN", aliases=("lrn",), num_inputs=1)
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across the channels of NCHW data."""
    x = data.to(torch.float32)
    half = nsize // 2
    padded = F.pad(x.square(), (0, 0, 0, 0, half, half))
    win = sum(padded[:, i:i + x.shape[1]] for i in range(nsize))
    return (x / (knorm + alpha * win / nsize).pow(beta)).to(data.dtype)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, training=False,
               generator=None):
    """``LeakyReLU``: leaky (``slope``), prelu (the learned ``gamma``, one
    a channel), elu, selu, gelu (the erf form) or rrelu, whose negative
    slopes are drawn uniformly in [lower_bound, upper_bound) in training
    (from ``generator``, default the data's device generator of
    :mod:`..random`) and are their mean otherwise."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 and data.dim() > 2 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(pos, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        if not training:
            return torch.where(pos, data,
                               (lower_bound + upper_bound) / 2.0 * data)
        if generator is None and data.device.type != "meta":
            from .. import random

            generator = random.generator(data.device)
        s = torch.rand(data.shape, generator=generator, device=data.device,
                       dtype=torch.float32)
        s = lower_bound + (upper_bound - lower_bound) * s
        return torch.where(pos, data, s.to(data.dtype) * data)
    raise ValueError("unknown act_type %r" % (act_type,))


@register("LeakyReLU")
def _leaky_relu_op(data, gamma=None, act_type="leaky", slope=0.25,
                   lower_bound=0.125, upper_bound=0.334):
    return leaky_relu(data, gamma, act_type, slope, lower_bound,
                      upper_bound, training=_is_train())


@register("SoftmaxActivation", num_inputs=1, aliases=("softmax_activation",))
def _softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


def resize_bilinear(data, height, width):
    """``jax.image.resize(data, (n, c, height, width), "bilinear")``:
    half-pixel centres, a triangle filter widened by the factor where
    the image shrinks (antialiased), the weights renormalized at the
    edges."""
    return F.interpolate(data, size=(int(height), int(width)),
                         mode="bilinear", align_corners=False,
                         antialias=True)


@register("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest: each input repeated ``scale`` times on H and W, then
    concatenated on the channels (or summed); bilinear: the first input
    resized by ``scale`` (the reference ignores the weight input)."""
    data = args[0]
    if sample_type == "nearest":
        outs = [a.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                    dim=3)
                for a in args]
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            return sum(outs)
        return torch.cat(outs, dim=1)
    return resize_bilinear(data, data.shape[2] * scale, data.shape[3] * scale)


@register("_contrib_BilinearResize2D", num_inputs=1,
          aliases=("BilinearResize2D",))
def _bilinear_resize(data, height=None, width=None, scale_height=None,
                     scale_width=None, mode="size", align_corners=True):
    """To (height, width), or the input's size times the scales; the
    reference ignores ``mode`` and ``align_corners`` (half-pixel
    centres always), and so does the port."""
    h, w = data.shape[2:]
    oh = int(height) if height else int(round(h * scale_height))
    ow = int(width) if width else int(round(w * scale_width))
    return resize_bilinear(data, oh, ow)


@register("_contrib_AdaptiveAvgPooling2D", num_inputs=1)
def _adaptive_avg_pool(data, output_size=(1, 1)):
    """The mean of equal blocks: each output size must divide the input's
    (the reference reshapes, and raises ``TypeError`` otherwise)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    n, c, h, w = data.shape
    oh, ow = (int(v) for v in output_size)
    if h % oh or w % ow:
        raise TypeError("AdaptiveAvgPooling2D takes output sizes that "
                        "divide the input's: (%d, %d) into (%d, %d)"
                        % (h, w, oh, ow))
    return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


_CTC_LOG_EPS = -1e5


def _ctc_phi_update(phi, added):
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                     dim=-1)


def ctc_forward(logits, logit_pad, labels, label_pad):
    """The CTC negative log-likelihood of each sequence (``optax.
    ctc_loss`` with blank 0 and log(0) taken as -1e5, which the
    reference calls): logits (B, T, K), paddings 1.0 where padded.
    The forward recursion runs in float64 (the reference's state
    starts as 64-bit ones), so an impossible alignment gives a large
    finite loss and the result is float64."""
    b, t, k = logits.shape
    n = labels.shape[1]
    f64 = torch.float64
    dev = logits.device
    logprobs = F.log_softmax(logits, dim=-1)
    labellens = n - label_pad.sum(dim=1).to(torch.int32)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(torch.float32),
                   (0, 1))
    lp_phi = logprobs[:, :, :1].transpose(0, 1)
    one_hot = (labels.to(torch.long)[..., None]
               == torch.arange(k, device=dev)).to(f64)
    lp_emit = torch.einsum("btk,bnk->tbn", logprobs.to(f64), one_hot)
    phi = torch.full((b, n + 1), _CTC_LOG_EPS, dtype=f64, device=dev)
    phi = torch.cat([torch.zeros((b, 1), dtype=f64, device=dev), phi[:, 1:]],
                    dim=1)
    emit = torch.full((b, n), _CTC_LOG_EPS, dtype=f64, device=dev)
    pads = logit_pad.transpose(0, 1)
    to_phi = _CTC_LOG_EPS * repeat
    to_rep = _CTC_LOG_EPS * (1.0 - repeat)
    for step in range(t):
        prev_phi_orig = phi
        prev_phi = _ctc_phi_update(phi, emit + to_phi)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[step],
                                    emit + lp_emit[step])
        next_phi = _ctc_phi_update(prev_phi + lp_phi[step],
                                   emit + lp_phi[step] + to_rep)
        pad = pads[step].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = _ctc_phi_update(phi, emit)
    return -torch.gather(last, 1, labellens.to(torch.long)[:, None])[:, 0]


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """CTC loss of logits (seq, batch, alphabet), blank at class 0 (for
    ``blank_label="last"`` too: the labels shift up by one, as the
    reference's), a label <= 0 marking padding unless lengths are
    given; float64, one value a sequence (see :func:`ctc_forward`)."""
    logits = data.transpose(0, 1)
    b, t, _ = logits.shape
    labels = label.to(torch.int32)
    if blank_label != "first":
        labels = labels + 1
    dev = data.device
    logit_pad = torch.zeros((b, t), dtype=torch.float64, device=dev)
    if use_data_lengths and data_lengths is not None:
        logit_pad = (torch.arange(t, device=dev)[None, :]
                     >= data_lengths.to(torch.int32)[:, None]).to(
                         torch.float32)
    label_pad = (labels <= 0).to(torch.float32)
    if use_label_lengths and label_lengths is not None:
        label_pad = (torch.arange(labels.shape[1], device=dev)[None, :]
                     >= label_lengths.to(torch.int32)[:, None]).to(
                         torch.float32)
    return ctc_forward(logits, logit_pad, labels, label_pad)
