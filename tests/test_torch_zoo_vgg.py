"""VGG (with and without BN), AlexNet and SqueezeNet 1.0/1.1 of the port
against the JAX package's: the eval forward and 3 training steps of
``test_torch_zoo.check_family`` (its docstring has the method and the
tolerances), dropout off on both sides.

VGG is width-reduced (``VGG([1, 1, 2, 2, 2], [8, 8, 16, 16, 16])``, its
dense layers stay 4096 wide) at 32 px; AlexNet and SqueezeNet take no
widths and run at full width on small images (63 px, the least AlexNet's
three pools take, and 64 px).
"""
import pytest

from incubator_mxnet_tpu.gluon.model_zoo.vision import alexnet as jalexnet
from incubator_mxnet_tpu.gluon.model_zoo.vision import squeezenet as jsq
from incubator_mxnet_tpu.gluon.model_zoo.vision import vgg as jvgg

from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
    alexnet as talexnet
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import squeezenet as tsq
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import vgg as tvgg

from test_torch_zoo import CLASSES, check_family


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg_matches_reference(batch_norm):
    layers, filters = [1, 1, 2, 2, 2], [8, 8, 16, 16, 16]
    check_family(
        lambda: jvgg.VGG(layers, filters, classes=CLASSES,
                         batch_norm=batch_norm),
        lambda: tvgg.VGG(layers, filters, classes=CLASSES,
                         batch_norm=batch_norm, device="cpu"),
        (2, 3, 32, 32))


def test_alexnet_matches_reference():
    check_family(lambda: jalexnet(classes=CLASSES),
                 lambda: talexnet(classes=CLASSES, device="cpu"),
                 (2, 3, 63, 63))


@pytest.mark.parametrize("version", ["1_0", "1_1"])
def test_squeezenet_matches_reference(version):
    name = "squeezenet" + version
    check_family(lambda: getattr(jsq, name)(classes=CLASSES),
                 lambda: getattr(tsq, name)(classes=CLASSES, device="cpu"),
                 (2, 3, 64, 64))
