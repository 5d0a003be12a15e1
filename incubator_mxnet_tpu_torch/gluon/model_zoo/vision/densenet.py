"""DenseNet 121/161/169/201 (port of ``incubator_mxnet_tpu/gluon/
model_zoo/vision/densenet.py``)."""
from __future__ import annotations

from .... import context
from ... import nn
from ...block import HybridBlock

__all__ = ["DenseNet", "densenet_spec", "densenet121", "densenet161",
           "densenet169", "densenet201"]


class _DenseLayer(HybridBlock):
    """BN, ReLU, 1x1 conv (``bn_size * growth_rate``), BN, ReLU, 3x3 conv
    (``growth_rate``), optional dropout; the output is concatenated to the
    input on channels."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    return nn.HybridSequential(*[_DenseLayer(growth_rate, bn_size, dropout)
                                 for _ in range(num_layers)])


def _make_transition(num_output_features):
    return nn.HybridSequential(
        nn.BatchNorm(), nn.Activation("relu"),
        nn.Conv2D(num_output_features, kernel_size=1, use_bias=False),
        nn.AvgPool2D(pool_size=2, strides=2))


class DenseNet(HybridBlock):
    """7x7/2 stem, BN, ReLU, 3x3/2 max pool; dense blocks joined by
    transitions that halve the channels (1x1 conv, 2x2/2 average pool);
    BN, ReLU, global average pooling and the classifier."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, device=None, **kwargs):
        super().__init__(**kwargs)
        with context.device_scope(device):
            self.features = nn.HybridSequential(
                nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                          padding=3, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(num_layers, bn_size,
                                                    growth_rate, dropout))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features = num_features // 2
                    self.features.add(_make_transition(num_features))
            self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                              nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _get_densenet(num_layers, pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kwargs):
    return _get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return _get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return _get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return _get_densenet(201, **kwargs)
