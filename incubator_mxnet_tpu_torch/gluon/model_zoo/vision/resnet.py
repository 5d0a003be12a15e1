"""ResNet v1 and v2 (port of ``incubator_mxnet_tpu/gluon/model_zoo/vision/
resnet.py``): stock BatchNorm blocks, the fused ghost-BN form of v1
(``ghost_bn=<group>``), the space-to-depth stem (``s2d_stem``), the
thumbnail stem, ``resnet_spec``, ``get_resnet`` and the 10
constructors.

Blocks are ``HybridBlock``s built in the reference's registration
order, so ``collect_params()`` names them as the reference does and
``convert.params_from_jax`` can carry weights across by position.  As
in the reference, the stock form leaves most input widths to the first
input (``gluon.shape_init``); the ghost form is given them all.  The
blocks, the stem and the nets run the reference's ``hybrid_forward`` on
tensors and on symbols alike, so ``export`` writes the reference's
graph; the ghost-BN layers keep a tensor ``forward`` (the module's
train mode, the running-stat commit) beside their symbolic body.
"""
from __future__ import annotations

import torch

from .... import context
from ....ops import nn as ops
from ....parallel import collectives
from ... import nn
from ...block import HybridBlock

__all__ = ["GhostBNReLU", "GhostBN", "BasicBlockV1", "BottleneckV1",
           "BasicBlockV2", "BottleneckV2", "ResNetV1", "ResNetV2",
           "resnet_spec", "get_resnet", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, device=None):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, device=device)


class _S2DStemConv(HybridBlock):
    """The 7x7 stride-2 pad-3 stem convolution computed as a 4x4 stride-1
    convolution over the 2x2 space-to-depth packing of its padded input
    (the same function): with ``ky = 2 kY + dy`` the kernel's taps become
    ``(kY, dy)`` pairs over packed channel ``4 c + 2 dy + dx``.  The
    weight keeps the (channels, in_channels, 7, 7) shape of the plain
    stem and is rearranged in the forward.  The input's height and width
    must be even."""

    def __init__(self, channels, in_channels=3, device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._channels = channels
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels, 7, 7),
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):  # noqa: N803
        x = F.pad(x, mode="constant", constant_value=0.0,
                  pad_width=(0, 0, 0, 0, 3, 3, 3, 3))        # (N,C,H+6,W+6)
        x = F.reshape(x, shape=(0, 0, -4, -1, 2, -4, -1, 2))  # (N,C,Y,dy,X,dx)
        x = F.transpose(x, axes=(0, 1, 3, 5, 2, 4))          # (N,C,dy,dx,Y,X)
        x = F.reshape(F.reshape(x, shape=(0, -3, -2)),
                      shape=(0, -3, -2))                     # (N,4C,Y,X)
        w = F.pad(weight, mode="constant", constant_value=0.0,
                  pad_width=(0, 0, 0, 0, 0, 1, 0, 1))        # (O,C,8,8)
        w = F.reshape(w, shape=(0, 0, -4, 4, 2, -4, 4, 2))   # (O,C,kY,dy,kX,dx)
        w = F.transpose(w, axes=(0, 1, 3, 5, 2, 4))          # (O,C,dy,dx,kY,kX)
        w = F.reshape(F.reshape(w, shape=(0, -3, -2)),
                      shape=(0, -3, -2))                     # (O,4C,4,4)
        return F.Convolution(x, w, num_filter=self._channels, kernel=(4, 4),
                             stride=(1, 1), pad=(0, 0), no_bias=True)


class GhostBNReLU(HybridBlock):
    """Fused ghost BN (+residual add) + ReLU with running stats.

    Parameters gamma and beta, buffers running_mean and running_var.  In
    training the statistics are per ghost group (``group`` is a cap) and
    the running stats move by ``momentum`` toward the merged batch stats.
    ``donate_residual`` marks the residual as dead after this layer (a
    downsample output); ``dual_out`` makes a residual exit return
    ``(out, out_shortcut)`` whose cotangents the backward kernel sums.
    ``track_stats=False`` makes no running stats and normalizes with the
    ghost groups' statistics in every mode (the reference's pipelined
    form, the ``NS`` ops).  On symbols it composes the reference's
    ``_contrib_GhostBN*`` op, whose running stats the executor moves."""

    _act = "relu"

    def __init__(self, group=0, momentum=0.9, epsilon=1e-5, in_channels=0,
                 donate_residual=False, track_stats=True, dual_out=False,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if in_channels <= 0:
            raise ValueError("%s needs in_channels: the port has no deferred "
                             "shape inference" % type(self).__name__)
        self._device = context.resolve(device)
        self._group = int(group)
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._donate_residual = bool(donate_residual)
        self._track_stats = bool(track_stats)
        self._dual_out = bool(dual_out)
        shape = (in_channels,)
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=shape, init="ones")
            self.beta = self.params.get("beta", shape=shape, init="zeros")
            if self._track_stats:
                self.running_mean = self.params.get(
                    "running_mean", grad_req="null", shape=shape,
                    init="zeros", buffer=True)
                self.running_var = self.params.get(
                    "running_var", grad_req="null", shape=shape,
                    init="ones", buffer=True)

    def _no_residual_form(self, residual):
        if residual is not None and not self._track_stats:
            raise ValueError("track_stats=False has no fused residual form; "
                             "add the residual outside")
        if residual is not None and self._act != "relu":
            raise ValueError("the fused residual form is BN+add+ReLU; %s "
                             "has no activation" % type(self).__name__)

    def forward(self, x, residual=None):
        self._no_residual_form(residual)
        if not self._track_stats:
            return ops.ghost_bn_nostats(x, self.gamma, self.beta,
                                        self._epsilon, self._group,
                                        self._act)
        kw = {"eps": self._epsilon, "group": self._group,
              "training": self.training}
        stats = (self.gamma, self.beta, self.running_mean, self.running_var)
        if residual is None:
            op = ops.ghost_bn_relu if self._act == "relu" else ops.ghost_bn
            out, bm, bv = op(x, *stats, **kw)
        else:
            kw["donate_residual"] = self._donate_residual
            if self._dual_out:
                out, out_sc, bm, bv = ops.ghost_bn_add_relu_dual(
                    x, residual, *stats, **kw)
                self._commit_running(bm, bv)
                return out, out_sc
            out, bm, bv = ops.ghost_bn_add_relu(x, residual, *stats, **kw)
        self._commit_running(bm, bv)
        return out

    def hybrid_forward(self, F, x, residual=None, *, gamma,  # noqa: N803
                       beta, running_mean=None, running_var=None):
        """The reference's symbolic body: no running-stat commit here (the
        executor commits the op's aux update)."""
        self._no_residual_form(residual)
        if not self._track_stats:
            op = (F._contrib_GhostBNReLUNS if self._act == "relu"
                  else F._contrib_GhostBNNS)
            return op(x, gamma, beta, eps=self._epsilon, group=self._group)
        kw = dict(eps=self._epsilon, momentum=self._momentum,
                  group=self._group)
        if residual is None:
            op = (F._contrib_GhostBNReLU if self._act == "relu"
                  else F._contrib_GhostBN)
            return op(x, gamma, beta, running_mean, running_var, **kw)[0]
        kw["donate_residual"] = 1 if self._donate_residual else 0
        if self._dual_out:
            out = F._contrib_GhostBNAddReLUDual(
                x, residual, gamma, beta, running_mean, running_var, **kw)
            return out[0], out[1]
        return F._contrib_GhostBNAddReLU(x, residual, gamma, beta,
                                         running_mean, running_var, **kw)[0]

    def _commit_running(self, bm, bv):
        """Move the running stats toward this batch's (bm, bv).  Inside a
        data-parallel step this rank's stats wait for the step's
        reduction, which hands back the global batch's mean and E[x^2]."""
        if not self.training:
            return
        dp = collectives.current_dp()
        if dp is not None:
            dp.defer_stats([bm, bv + bm * bm], lambda m, e2: self._move(
                m, torch.clamp_min(e2 - m * m, 0.0)))
            return
        self._move(bm, bv)

    def _move(self, bm, bv):
        with torch.no_grad():
            rm, rv = ops.ghost_bn_aux_update(self.running_mean,
                                             self.running_var, bm, bv,
                                             self._momentum)
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)


class GhostBN(GhostBNReLU):
    """Fused ghost BN without activation (the downsample branch)."""

    _act = "none"


class BasicBlockV1(HybridBlock):
    """ResNet v1 basic block: two 3x3 conv + BN pairs and the residual
    add + ReLU; with ``ghost_bn`` the BNs are fused ghost BN, the exit
    with the add and ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 ghost_bn=0, dual_out=False, device=None, **kwargs):
        super().__init__(**kwargs)
        self._ghost_bn = ghost_bn
        if ghost_bn:
            self.conv1 = _conv3x3(channels, stride, in_channels, device)
            self.gbn1 = GhostBNReLU(group=ghost_bn, in_channels=channels,
                                    device=device)
            self.conv2 = _conv3x3(channels, 1, channels, device)
            self.gbn2 = GhostBNReLU(group=ghost_bn, donate_residual=downsample,
                                    dual_out=dual_out, in_channels=channels,
                                    device=device)
        else:
            self.body = nn.HybridSequential(
                _conv3x3(channels, stride, in_channels, device),
                nn.BatchNorm(device=device), nn.Activation("relu"),
                _conv3x3(channels, 1, channels, device),
                nn.BatchNorm(device=device))
        self.downsample = _downsample(channels, stride, in_channels, ghost_bn,
                                      device) if downsample else None

    def hybrid_forward(self, F, x):  # noqa: N803
        if self._ghost_bn:
            x, shortcut = x if isinstance(x, tuple) else (x, x)
            residual = shortcut
            if self.downsample is not None:
                residual = self.downsample(shortcut)
            x = self.gbn1(self.conv1(x))
            return self.gbn2(self.conv2(x), residual)
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


def _downsample(channels, stride, in_channels, ghost_bn, device):
    """The v1 shortcut: 1x1 conv, then BN (ghost BN without activation in
    the ghost form)."""
    bn = GhostBN(group=ghost_bn, in_channels=channels, device=device) \
        if ghost_bn else nn.BatchNorm(device=device)
    return nn.HybridSequential(
        nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                  in_channels=in_channels, device=device), bn)


class BottleneckV1(HybridBlock):
    """ResNet v1 bottleneck: 1x1 (carrying the stride), 3x3 and 1x1 conv +
    BN and the residual add + ReLU.  With ``ghost_bn``: three conv ->
    ghost-BN pairs, the exit fused with the residual add and ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 ghost_bn=0, dual_out=False, device=None, **kwargs):
        super().__init__(**kwargs)
        self._ghost_bn = ghost_bn
        mid = channels // 4
        if ghost_bn:
            self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=stride,
                                   use_bias=False, in_channels=in_channels,
                                   device=device)
            self.gbn1 = GhostBNReLU(group=ghost_bn, in_channels=mid,
                                    device=device)
            self.conv2 = _conv3x3(mid, 1, mid, device)
            self.gbn2 = GhostBNReLU(group=ghost_bn, in_channels=mid,
                                    device=device)
            self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                                   use_bias=False, in_channels=mid,
                                   device=device)
            self.gbn3 = GhostBNReLU(group=ghost_bn, donate_residual=downsample,
                                    dual_out=dual_out, in_channels=channels,
                                    device=device)
        else:
            self.body = nn.HybridSequential(
                nn.Conv2D(mid, kernel_size=1, strides=stride, device=device),
                nn.BatchNorm(device=device), nn.Activation("relu"),
                _conv3x3(mid, 1, mid, device),
                nn.BatchNorm(device=device), nn.Activation("relu"),
                nn.Conv2D(channels, kernel_size=1, strides=1, device=device),
                nn.BatchNorm(device=device))
        self.downsample = _downsample(channels, stride, in_channels, ghost_bn,
                                      device) if downsample else None

    def hybrid_forward(self, F, x):  # noqa: N803
        if self._ghost_bn:
            # a dual-output predecessor hands over (conv_path, shortcut)
            x, shortcut = x if isinstance(x, tuple) else (x, x)
            residual = shortcut
            if self.downsample is not None:
                residual = self.downsample(shortcut)
            x = self.gbn1(self.conv1(x))
            x = self.gbn2(self.conv2(x))
            return self.gbn3(self.conv3(x), residual)
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block: BN, ReLU, 3x3 conv, twice; the shortcut
    (a 1x1 conv where it downsamples) taken after the first BN + ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm(device=device)
        self.conv1 = _conv3x3(channels, stride, in_channels, device)
        self.bn2 = nn.BatchNorm(device=device)
        self.conv2 = _conv3x3(channels, 1, channels, device)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            device=device) if downsample else None

    def hybrid_forward(self, F, x):  # noqa: N803
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.Activation(self.bn2(x), act_type="relu"))
        return x + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck: BN, ReLU and conv three times (1x1, 3x3
    carrying the stride, 1x1); the shortcut as in ``BasicBlockV2``."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(device=device)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                               device=device)
        self.bn2 = nn.BatchNorm(device=device)
        self.conv2 = _conv3x3(mid, stride, mid, device)
        self.bn3 = nn.BatchNorm(device=device)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, device=device)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            device=device) if downsample else None

    def hybrid_forward(self, F, x):  # noqa: N803
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.Activation(self.bn2(x), act_type="relu"))
        x = self.conv3(F.Activation(self.bn3(x), act_type="relu"))
        return x + residual


def _make_layer(block, layers, channels, stride, in_channels=0, ghost_bn=0,
                last_stage=False, device=None):
    """One stage: a block that may downsample, then ``layers - 1`` more.
    In the ghost form every block exit but the net's last is
    dual-output: the next block takes (conv_path, shortcut) and the
    exit's backward sums the two cotangents."""
    def kw(is_tail):
        if not ghost_bn:
            return {"device": device}
        return {"ghost_bn": ghost_bn,
                "dual_out": not (last_stage and is_tail), "device": device}
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, **kw(layers == 1)))
    for j in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        **kw(j == layers - 2)))
    return layer


class ResNetV1(HybridBlock):
    """ResNet v1: the 7x7/2 stem (or its space-to-depth form, or a 3x3
    thumbnail stem with no BN or pool), BN + ReLU, the 3x3/2 max pool,
    the stages, global average pooling and the classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 s2d_stem=False, ghost_bn=0, device=None, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        with context.device_scope(device) as dev:
            self.features = nn.HybridSequential()
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                if s2d_stem:
                    self.features.add(_S2DStemConv(channels[0]))
                else:
                    self.features.add(nn.Conv2D(
                        channels[0], 7, 2, 3, use_bias=False,
                        in_channels=3 if ghost_bn else 0))
                if ghost_bn:
                    self.features.add(GhostBNReLU(
                        group=ghost_bn, in_channels=channels[0]))
                else:
                    self.features.add(nn.BatchNorm(), nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride,
                    in_channels=channels[i], ghost_bn=ghost_bn,
                    last_stage=(i == len(layers) - 1), device=dev))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(F.Flatten(self.features(x)))


class ResNetV2(HybridBlock):
    """ResNet v2 (pre-activation): a BN without scale or shift on the
    input (gamma and beta without gradient), the stem, the stages, BN +
    ReLU, global average pooling and the classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        with context.device_scope(device) as dev:
            self.features = nn.HybridSequential(
                nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False),
                                  nn.BatchNorm(), nn.Activation("relu"),
                                  nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride,
                    in_channels=in_channels, device=dev))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                              nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to ``ResNetV1`` / ``ResNetV2`` (``classes``,
    ``thumbnail``, ``device``; v1 also ``s2d_stem`` and ``ghost_bn``).
    There are no pretrained weights."""
    if num_layers not in resnet_spec:
        raise ValueError("no ResNet of %r layers; the spec has %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("ResNet version is 1 or 2, got %r" % (version,))
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    block_type, layers, channels = resnet_spec[num_layers]
    block = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
