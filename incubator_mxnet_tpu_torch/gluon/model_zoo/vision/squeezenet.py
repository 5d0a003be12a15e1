"""SqueezeNet 1.0 and 1.1 (port of ``incubator_mxnet_tpu/gluon/model_zoo/
vision/squeezenet.py``)."""
from __future__ import annotations

from .... import context
from ... import nn
from ...block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    """1x1 squeeze, then 1x1 and 3x3 expands concatenated on channels."""

    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")

    def hybrid_forward(self, F, x):  # noqa: N803
        x = self.squeeze(x)
        return F.Concat(self.expand1x1(x), self.expand3x3(x), dim=1)


class SqueezeNet(HybridBlock):
    """Fire modules between 3x3/2 ceil-mode max pools, dropout 0.5, a 1x1
    classifier convolution and global average pooling."""

    def __init__(self, version, classes=1000, device=None, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise ValueError("SqueezeNet version is '1.0' or '1.1', got %r"
                             % (version,))

        def pool():
            return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)

        with context.device_scope(device):
            self.features = nn.HybridSequential()
            if version == "1.0":
                self.features.add(
                    nn.Conv2D(96, kernel_size=7, strides=2,
                              activation="relu"), pool(),
                    _Fire(16, 64, 64), _Fire(16, 64, 64),
                    _Fire(32, 128, 128), pool(),
                    _Fire(32, 128, 128), _Fire(48, 192, 192),
                    _Fire(48, 192, 192), _Fire(64, 256, 256), pool(),
                    _Fire(64, 256, 256))
            else:
                self.features.add(
                    nn.Conv2D(64, kernel_size=3, strides=2,
                              activation="relu"), pool(),
                    _Fire(16, 64, 64), _Fire(16, 64, 64), pool(),
                    _Fire(32, 128, 128), _Fire(32, 128, 128), pool(),
                    _Fire(48, 192, 192), _Fire(48, 192, 192),
                    _Fire(64, 256, 256), _Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(
                nn.Conv2D(classes, kernel_size=1, activation="relu"),
                nn.GlobalAvgPool2D(), nn.Flatten())

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    return SqueezeNet("1.1", **kwargs)
