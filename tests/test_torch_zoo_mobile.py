"""DenseNet and MobileNet v1/v2 of the port against the JAX package's.

DenseNet (width-reduced: ``DenseNet(8, 4, [2, 2], bn_size=2)``, 8 stem
channels, growth rate 4, two dense blocks of two layers and a
transition) takes ``test_torch_zoo.check_family``: the eval forward and
3 training steps (its docstring has the method and the tolerances).

MobileNet v1 and v2 run at multiplier 0.25 at full depth (27 and 52
conv + BN layers), at batch 2, 64 px.  At init their gradients are ~100
for a loss of ~2.4 and explode through the plain BN stack: a 3e-5
difference in the weights after one step grows ~20x a step at any lr
from 1e-4 to 1e-2, on both sides, so 3 steps cannot be compared.  And
where a BN follows a linear layer its gamma's gradient is zero in exact
arithmetic, so such tensors hold rounding noise.  Hence, after the eval
forward (1e-4, as ``check_family``), one training forward and backward:

- the loss within 1e-4 of the reference's, the running stats after it
  within 1e-4 of the reference's;
- the gradients by the median over tensors of each tensor's largest
  difference over its largest magnitude (``chip_smoke.py`` phase 5's
  statistic): against the reference at most 4x the port's own median
  distance from the same net computed in f64, plus 1e-3; and that f64
  distance at most 1e-2.  The reference computes BN's variance in one f32
  pass, E[x^2] - E[x]^2, which cancels where a channel's mean is large
  against its spread (ROADMAP Queue C): at batch 8 its median distance
  from the f64 gradients is 2.5e-2 where the port's is 8e-6.
"""
from incubator_mxnet_tpu.gluon.model_zoo.vision import densenet as jdense
from incubator_mxnet_tpu.gluon.model_zoo.vision import mobilenet as jmob

from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import densenet as tdense
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet as tmob

from test_torch_zoo import CLASSES, check_family, check_first_step

SHAPE = (2, 3, 32, 32)
MOBILE_SHAPE = (2, 3, 64, 64)


def test_densenet_matches_reference():
    check_family(
        lambda: jdense.DenseNet(8, 4, [2, 2], bn_size=2, classes=CLASSES),
        lambda: tdense.DenseNet(8, 4, [2, 2], bn_size=2, classes=CLASSES,
                                device="cpu"),
        SHAPE)


def test_mobilenet_v1_matches_reference():
    check_first_step(lambda: jmob.mobilenet0_25(classes=CLASSES),
                     lambda: tmob.mobilenet0_25(classes=CLASSES,
                                                device="cpu"), MOBILE_SHAPE)


def test_mobilenet_v2_matches_reference():
    check_first_step(lambda: jmob.mobilenet_v2_0_25(classes=CLASSES),
                     lambda: tmob.mobilenet_v2_0_25(classes=CLASSES,
                                                    device="cpu"),
                     MOBILE_SHAPE)
