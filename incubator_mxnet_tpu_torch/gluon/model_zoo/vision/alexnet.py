"""AlexNet (port of ``incubator_mxnet_tpu/gluon/model_zoo/vision/
alexnet.py``)."""
from __future__ import annotations

from .... import context
from ... import nn
from ...block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """Five convolutions (three 3x3/2 max pools), two dense layers of 4096
    with dropout 0.5, the classifier.  Input widths are deferred."""

    def __init__(self, classes=1000, device=None, **kwargs):
        super().__init__(**kwargs)
        with context.device_scope(device):
            self.features = nn.HybridSequential(
                nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                          activation="relu"),
                nn.MaxPool2D(pool_size=3, strides=2),
                nn.Conv2D(192, kernel_size=5, padding=2, activation="relu"),
                nn.MaxPool2D(pool_size=3, strides=2),
                nn.Conv2D(384, kernel_size=3, padding=1, activation="relu"),
                nn.Conv2D(256, kernel_size=3, padding=1, activation="relu"),
                nn.Conv2D(256, kernel_size=3, padding=1, activation="relu"),
                nn.MaxPool2D(pool_size=3, strides=2),
                nn.Flatten(),
                nn.Dense(4096, activation="relu"),
                nn.Dropout(0.5),
                nn.Dense(4096, activation="relu"),
                nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available")
    return AlexNet(**kwargs)
