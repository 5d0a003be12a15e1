"""ResNet v1 with fused ghost batch norm (port of ``incubator_mxnet_tpu/
gluon/model_zoo/vision/resnet.py``: ``GhostBNReLU``, ``GhostBN``,
``BottleneckV1``, ``ResNetV1``, ``resnet50_v1``).

Only the ghost-BN form is ported.  ``ghost_bn=0`` (stock BatchNorm) and
``s2d_stem=True`` (the space-to-depth stem) raise ``NotImplementedError``
naming their ROADMAP items.  Modules are built in the reference's
registration order, so ``convert.params_from_jax`` can carry weights
across by position.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from .... import context
from ....ops import nn as ops
from ... import nn

__all__ = ["GhostBNReLU", "GhostBN", "BottleneckV1", "ResNetV1",
           "resnet50_v1"]


def _conv3x3(channels, stride, in_channels, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, device=device)


class GhostBNReLU(tnn.Module):
    """Fused ghost BN (+residual add) + ReLU with running stats.

    Parameters gamma and beta, buffers running_mean and running_var.  In
    training the statistics are per ghost group (``group`` is a cap) and
    the running stats move by ``momentum`` toward the merged batch stats.
    ``donate_residual`` marks the residual as dead after this layer (a
    downsample output); ``dual_out`` makes a residual exit return
    ``(out, out_shortcut)`` whose cotangents the backward kernel sums."""

    _act = "relu"

    def __init__(self, group=0, momentum=0.9, epsilon=1e-5, in_channels=0,
                 donate_residual=False, dual_out=False, device=None):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("%s needs in_channels: the port has no deferred "
                             "shape inference" % type(self).__name__)
        dev = context.resolve(device)
        self._group = int(group)
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._donate_residual = bool(donate_residual)
        self._dual_out = bool(dual_out)
        self.gamma = tnn.Parameter(torch.ones(in_channels, device=dev))
        self.beta = tnn.Parameter(torch.zeros(in_channels, device=dev))
        self.register_buffer("running_mean",
                             torch.zeros(in_channels, device=dev))
        self.register_buffer("running_var", torch.ones(in_channels, device=dev))

    def forward(self, x, residual=None):
        kw = {"eps": self._epsilon, "group": self._group,
              "training": self.training}
        stats = (self.gamma, self.beta, self.running_mean, self.running_var)
        if residual is None:
            op = ops.ghost_bn_relu if self._act == "relu" else ops.ghost_bn
            out, bm, bv = op(x, *stats, **kw)
        else:
            if self._act != "relu":
                raise ValueError("the fused residual form is BN+add+ReLU; %s "
                                 "has no activation" % type(self).__name__)
            kw["donate_residual"] = self._donate_residual
            if self._dual_out:
                out, out_sc, bm, bv = ops.ghost_bn_add_relu_dual(
                    x, residual, *stats, **kw)
                self._commit_running(bm, bv)
                return out, out_sc
            out, bm, bv = ops.ghost_bn_add_relu(x, residual, *stats, **kw)
        self._commit_running(bm, bv)
        return out

    def _commit_running(self, bm, bv):
        if not self.training:
            return
        with torch.no_grad():
            rm, rv = ops.ghost_bn_aux_update(self.running_mean,
                                             self.running_var, bm, bv,
                                             self._momentum)
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)


class GhostBN(GhostBNReLU):
    """Fused ghost BN without activation (the downsample branch)."""

    _act = "none"


class BottleneckV1(tnn.Module):
    """ResNet v1 bottleneck in the ghost-BN layout: three conv ->
    ghost-BN pairs, the exit fused with the residual add and ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 ghost_bn=0, dual_out=False, device=None):
        super().__init__()
        if not ghost_bn:
            raise NotImplementedError(
                "stock BatchNorm (ghost_bn=0) is not ported yet: ROADMAP "
                "Queue A, item A3b")
        mid = channels // 4
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=stride,
                               use_bias=False, in_channels=in_channels,
                               device=device)
        self.gbn1 = GhostBNReLU(group=ghost_bn, in_channels=mid, device=device)
        self.conv2 = _conv3x3(mid, 1, mid, device)
        self.gbn2 = GhostBNReLU(group=ghost_bn, in_channels=mid, device=device)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid, device=device)
        self.gbn3 = GhostBNReLU(group=ghost_bn, donate_residual=downsample,
                                dual_out=dual_out, in_channels=channels,
                                device=device)
        if downsample:
            self.downsample = nn.HybridSequential(
                nn.Conv2D(channels, kernel_size=1, strides=stride,
                          use_bias=False, in_channels=in_channels,
                          device=device),
                GhostBN(group=ghost_bn, in_channels=channels, device=device))
        else:
            self.downsample = None

    def forward(self, x):
        # a dual-output predecessor hands over (conv_path, shortcut)
        x, shortcut = x if isinstance(x, tuple) else (x, x)
        residual = shortcut
        if self.downsample is not None:
            residual = self.downsample(shortcut)
        x = self.gbn1(self.conv1(x))
        x = self.gbn2(self.conv2(x))
        return self.gbn3(self.conv3(x), residual)


class ResNetV1(tnn.Module):
    def __init__(self, block, layers, channels, classes=1000, s2d_stem=False,
                 ghost_bn=0, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        if not ghost_bn:
            raise NotImplementedError(
                "stock BatchNorm (ghost_bn=0) is not ported yet: ROADMAP "
                "Queue A, item A3b")
        if s2d_stem:
            raise NotImplementedError(
                "the space-to-depth stem is not ported yet: ROADMAP Queue "
                "A, item A4b")
        dev = context.resolve(device)
        self.features = nn.HybridSequential(
            nn.Conv2D(channels[0], 7, 2, 3, use_bias=False, in_channels=3,
                      device=dev),
            GhostBNReLU(group=ghost_bn, in_channels=channels[0], device=dev),
            nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i], ghost_bn=ghost_bn,
                last_stage=(i == len(layers) - 1), device=dev))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1], device=dev)

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels=0,
                    ghost_bn=0, last_stage=False, device=None):
        # every block exit but the net's last is dual-output: the next
        # block takes (conv_path, shortcut) and the exit's backward sums
        # the two cotangents
        def kw(is_tail):
            return {"ghost_bn": ghost_bn,
                    "dual_out": not (last_stage and is_tail),
                    "device": device}
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, **kw(layers == 1)))
        for j in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            **kw(j == layers - 2)))
        return layer

    def forward(self, x):
        x = self.features(x)
        return self.output(ops.flatten(x))


def resnet50_v1(**kwargs):
    """ResNet-50 v1 (``resnet_spec[50]`` of the reference)."""
    return ResNetV1(BottleneckV1, [3, 4, 6, 3], [64, 256, 512, 1024, 2048],
                    **kwargs)
