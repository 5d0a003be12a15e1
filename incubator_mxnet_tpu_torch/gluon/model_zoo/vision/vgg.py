"""VGG 11/13/16/19, with and without BN (port of
``incubator_mxnet_tpu/gluon/model_zoo/vision/vgg.py``)."""
from __future__ import annotations

from .... import context
from ... import nn
from ...block import HybridBlock

__all__ = ["VGG", "vgg_spec", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    """Stages of 3x3 convolutions (+ BN) + ReLU, each closed by a 2x2/2 max
    pool; two dense layers of 4096 with dropout 0.5; the classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("need one filter count per stage")
        with context.device_scope(device):
            self.features = nn.HybridSequential()
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(nn.Conv2D(filters[i], kernel_size=3,
                                                padding=1))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(strides=2))
            self.features.add(nn.Flatten(),
                              nn.Dense(4096, activation="relu"),
                              nn.Dropout(rate=0.5),
                              nn.Dense(4096, activation="relu"),
                              nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
