"""Inception v3 (port of ``incubator_mxnet_tpu/gluon/model_zoo/vision/
inception.py``)."""
from __future__ import annotations

from .... import context
from ... import nn
from ...block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    return nn.HybridSequential(nn.Conv2D(use_bias=False, **kwargs),
                               nn.BatchNorm(epsilon=0.001),
                               nn.Activation("relu"))


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel_size, strides, padding in conv_settings:
        kwargs = {"channels": channels, "kernel_size": kernel_size}
        if strides is not None:
            kwargs["strides"] = strides
        if padding is not None:
            kwargs["padding"] = padding
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches on one input, concatenated on ``axis`` (gluon
    contrib's ``HybridConcurrent``)."""

    def __init__(self, axis=1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def add(self, block):
        self.register_child(block)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Concat(*[child(x) for child in self], dim=self._axis)


def _make_A(pool_features):  # noqa: N802
    out = _Concurrent()
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B():  # noqa: N802
    out = _Concurrent()
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7):  # noqa: N802
    out = _Concurrent()
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D():  # noqa: N802
    out = _Concurrent()
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.branch1 = _make_branch(None, (320, 1, None, None))
        self.branch2_stem = _make_branch(None, (384, 1, None, None))
        self.branch2_a = _make_branch(None, (384, (1, 3), None, (0, 1)))
        self.branch2_b = _make_branch(None, (384, (3, 1), None, (1, 0)))
        self.branch3_stem = _make_branch(None, (448, 1, None, None),
                                         (384, 3, None, 1))
        self.branch3_a = _make_branch(None, (384, (1, 3), None, (0, 1)))
        self.branch3_b = _make_branch(None, (384, (3, 1), None, (1, 0)))
        self.branch4 = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):  # noqa: N803
        b1 = self.branch1(x)
        s2 = self.branch2_stem(x)
        b2 = F.Concat(self.branch2_a(s2), self.branch2_b(s2), dim=1)
        s3 = self.branch3_stem(x)
        b3 = F.Concat(self.branch3_a(s3), self.branch3_b(s3), dim=1)
        return F.Concat(b1, b2, b3, self.branch4(x), dim=1)


class Inception3(HybridBlock):
    """Inception v3 for 299 px inputs: the stem (five conv + BN + ReLU,
    two 3x3/2 max pools), Inception A x3, B, C x4, D, E x2, an 8x8
    average pool, dropout 0.5 and the classifier."""

    def __init__(self, classes=1000, device=None, **kwargs):
        super().__init__(**kwargs)
        with context.device_scope(device):
            self.features = nn.HybridSequential(
                _make_basic_conv(channels=32, kernel_size=3, strides=2),
                _make_basic_conv(channels=32, kernel_size=3),
                _make_basic_conv(channels=64, kernel_size=3, padding=1),
                nn.MaxPool2D(pool_size=3, strides=2),
                _make_basic_conv(channels=80, kernel_size=1),
                _make_basic_conv(channels=192, kernel_size=3),
                nn.MaxPool2D(pool_size=3, strides=2),
                _make_A(32), _make_A(64), _make_A(64), _make_B(),
                _make_C(128), _make_C(160), _make_C(160), _make_C(192),
                _make_D(), _InceptionE(), _InceptionE(),
                nn.AvgPool2D(pool_size=8), nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(F.Flatten(self.features(x)))


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    return Inception3(**kwargs)
