"""MobileNet v1 and v2 at four width multipliers (port of
``incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``)."""
from __future__ import annotations

from .... import context
from ... import nn
from ...block import HybridBlock

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _relu6():
    return nn.HybridLambda(lambda F, x: F.clip(x, 0, 6))


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(_relu6() if relu6 else nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual: 1x1 expansion by ``t``, 3x3
    depthwise (carrying the stride), 1x1 linear projection; the input is
    added where shapes allow."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):  # noqa: N803
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNet(HybridBlock):
    """MobileNet v1: a 3x3/2 conv, 13 depthwise-separable pairs, global
    average pooling and the classifier; widths scaled by ``multiplier``."""

    def __init__(self, multiplier=1.0, classes=1000, device=None, **kwargs):
        super().__init__(**kwargs)
        with context.device_scope(device):
            self.features = nn.HybridSequential()
            _add_conv(self.features, channels=int(32 * multiplier),
                      kernel=3, pad=1, stride=2)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6
                        + [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                             stride=s)
            self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet v2: a 3x3/2 conv, 17 linear bottlenecks, a 1x1 conv to
    1280 (scaled above multiplier 1), global average pooling and a 1x1
    classifier convolution; ReLU6 throughout."""

    def __init__(self, multiplier=1.0, classes=1000, device=None, **kwargs):
        super().__init__(**kwargs)
        with context.device_scope(device):
            self.features = nn.HybridSequential()
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1, relu6=True)
            in_channels_group = [int(x * multiplier) for x in
                                 [32] + [16] + [24] * 2 + [32] * 3
                                 + [64] * 4 + [96] * 3 + [160] * 3]
            channels_group = [int(x * multiplier) for x in
                              [16] + [24] * 2 + [32] * 3 + [64] * 4
                              + [96] * 3 + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2] + [1, 2] + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
            for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                     strides):
                self.features.add(LinearBottleneck(in_channels=in_c,
                                                   channels=c, t=t, stride=s))
            last_channels = int(1280 * multiplier) if multiplier > 1.0 \
                else 1280
            _add_conv(self.features, last_channels, relu6=True)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(
                nn.Conv2D(classes, 1, use_bias=False), nn.Flatten())

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


def _checked(pretrained):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")


def mobilenet1_0(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNet(1.0, **kwargs)


def mobilenet0_75(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNet(0.75, **kwargs)


def mobilenet0_5(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNet(0.5, **kwargs)


def mobilenet0_25(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNet(0.25, **kwargs)


def mobilenet_v2_1_0(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNetV2(1.0, **kwargs)


def mobilenet_v2_0_75(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNetV2(0.75, **kwargs)


def mobilenet_v2_0_5(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNetV2(0.5, **kwargs)


def mobilenet_v2_0_25(pretrained=False, **kwargs):
    _checked(pretrained)
    return MobileNetV2(0.25, **kwargs)
