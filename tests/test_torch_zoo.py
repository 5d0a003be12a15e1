"""The port's vision zoo against the JAX package's: the registry and the
ResNet family (stock BatchNorm, v1 and v2).

For each net, the JAX net is built, initialized and its shapes resolved
(``shape_init``); the port's is built with deferred widths, resolved by
``gluon.shape_init`` and loaded with the JAX net's weights by position
(``convert.params_from_jax``, which checks every shape).  Then:

- the eval forward (running stats) of one numpy batch, and
- 3 training steps of ``test_torch_train_step.py``'s optimizer (sgd,
  momentum 0.9, lr 0.01, wd 1e-4, ``multi_precision``, a dynamic loss
  scale) on numpy batches, f32: the per-step losses, then every
  parameter and running stat, and the split into trained parameters and
  the aux set (running stats and gamma/beta without gradient),

with dropout rates set to 0 on both nets (dropout is held to its
definition in ``test_torch_batch_norm.py``).  The other families are in
``test_torch_zoo_{vgg,mobile,inception}.py``, which use
:func:`check_family`.

The registry: ``get_model`` builds all 34 names of the reference's, and
each full-width net (224 px; Inception 299) has the reference's count of
parameters and running stats (``REFERENCE_COUNTS``, the values of the
JAX package's ``collect_params()`` at the default 1000 classes; one net
is counted live on both sides).

Tolerances (f32): 1e-4 absolute for logits, losses, parameters and
running stats, as ``test_torch_train_step.py``.  The ResNet v1 with its
7x7/2 stem and 3x3/2 max pool at 64 px trains at lr 1e-3, as
``test_torch_train_step_checkpoint.py``'s cross-package steps do: a
max-pool near-tie that f32 rounding flips in the first step moves the
stem's weights by 4.5e-4 after the second step at lr 0.01 and by 1.9e-2
after the third, on both sides, while lr 1e-3 stays within 6e-6.
MobileNet and the Inception blocks net are compared over one step
(:func:`check_first_step`, see ``test_torch_zoo_mobile.py``).
"""
import copy

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, nd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from incubator_mxnet_tpu.parallel import make_train_step as jmake

from incubator_mxnet_tpu_torch import convert, gluon
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.parallel import make_train_step

OPT = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9, wd=1e-4,
           multi_precision=True, loss_scale="dynamic")
CLASSES = 10


def _zero_dropout_jax(block):
    if isinstance(block, jgluon.nn.Dropout):
        block._rate = 0.0
    for child in block._children.values():
        _zero_dropout_jax(child)


def build_pair(jbuild, tbuild, shape, seed=0):
    """(jax_net, port_net) with the JAX net's weights in both and dropout
    off; ``tbuild`` builds on the CPU."""
    mx.random.seed(seed)
    jnet = jbuild()
    jnet.initialize(init=mx.init.Xavier())
    jnet.shape_init(shape)
    tnet = tbuild()
    gluon.shape_init(tnet, shape)
    convert.params_from_jax(tnet, [p.data().asnumpy()
                                   for p in jnet.collect_params().values()])
    _zero_dropout_jax(jnet)
    for m in tnet.modules():
        if isinstance(m, gluon.nn.Dropout):
            m._rate = 0.0
    return jnet, tnet


def check_eval(jnet, tnet, x):
    """The eval forward (running stats) of ``x`` on both nets, 1e-4."""
    jout = jnet(nd.array(x)).asnumpy()
    tnet.eval()
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x)).numpy()
    assert tout.shape == jout.shape == (x.shape[0], CLASSES)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-4)


def check_family(jbuild, tbuild, shape, seed=0, lr=0.01):
    """The eval forward and 3 training steps at learning rate ``lr`` of
    the pair, as the module docstring says."""
    jnet, tnet = build_pair(jbuild, tbuild, shape, seed)
    jnet.hybridize()  # its forwards as compiled programs, not op by op
    rng = np.random.RandomState(seed + 100)
    check_eval(jnet, tnet, rng.normal(size=shape).astype(np.float32))

    opt = dict(OPT, learning_rate=lr)
    jstep = jmake(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), lint="off",
                  **opt)
    tstep = make_train_step(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                            device="cpu", **opt)
    for _ in range(3):
        x = rng.normal(size=shape).astype(np.float32)
        y = rng.randint(0, CLASSES, shape[0]).astype(np.float32)
        jl = float(jstep(nd.array(x), nd.array(y)).asnumpy())
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y)).item()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert (len(tstep._gp), len(tstep._aux)) == \
        (len(jstep._gp), len(jstep._aux))
    params = list(jnet.collect_params().values())
    tensors = convert.ordered_tensors(tnet)
    assert len(tensors) == len(params)
    for p, (name, t) in zip(params, tensors):
        np.testing.assert_allclose(t.detach().numpy(), p.data().asnumpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert tstep.skipped_steps == jstep.skipped_steps == 0
    return jnet, tnet, tstep


def _port_grads(net, x, y):
    net.train()
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
        net(x), y).mean()
    loss.backward()
    return loss.item(), [t.grad for _, t in convert.ordered_tensors(net)
                         if isinstance(t, torch.nn.Parameter)]


def _median_rel(got, want):
    return float(np.median([np.abs(g - w).max() / np.abs(w).max()
                            for g, w in zip(got, want)]))


def check_first_step(jbuild, tbuild, shape):
    """The eval forward, then one training forward and backward, held as
    ``test_torch_zoo_mobile.py``'s docstring says: for nets whose
    training steps cannot be compared over 3 steps."""
    jnet, tnet = build_pair(jbuild, tbuild, shape)
    jnet.hybridize()  # its forwards as compiled programs, not op by op
    rng = np.random.RandomState(100)
    check_eval(jnet, tnet, rng.normal(size=shape).astype(np.float32))
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.randint(0, CLASSES, shape[0]).astype(np.float32)
    t64 = copy.deepcopy(tnet).double()
    with autograd.record():
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(nd.array(x)), nd.array(y)).mean()
    jloss.backward()
    tl, tgrads = _port_grads(tnet, torch.from_numpy(x), torch.from_numpy(y))
    _, grads64 = _port_grads(t64, torch.from_numpy(x).double(),
                             torch.from_numpy(y))
    np.testing.assert_allclose(tl, float(jloss.asnumpy()), rtol=0, atol=1e-4)
    params = [p for p in jnet.collect_params().values()
              if p.grad_req != "null"]
    assert len(params) == len(tgrads) == len(grads64)
    port = [g.numpy() for g in tgrads]
    floor = _median_rel(port, [g.numpy() for g in grads64])
    err = _median_rel(port, [p.grad().asnumpy() for p in params])
    assert floor <= 1e-2, floor
    assert err <= 4 * floor + 1e-3, (err, floor)
    stats = [p for p in jnet.collect_params().values()
             if p.grad_req == "null"]
    tstats = [t for _, t in convert.ordered_tensors(tnet)
              if not isinstance(t, torch.nn.Parameter)]
    assert len(stats) == len(tstats)
    for p, t in zip(stats, tstats):
        np.testing.assert_allclose(t.numpy(), p.data().asnumpy(), rtol=0,
                                   atol=1e-4, err_msg=p.name)


def _resnet(mod, version, block, layers, channels, **kw):
    cls = getattr(mod, "ResNetV%d" % version)
    extra = {"device": "cpu"} if mod is tres else {}
    return cls(getattr(mod, block), layers, channels, classes=CLASSES,
               **kw, **extra)


RESNETS = [
    # (version, block, channels, thumbnail, image, lr)
    (1, "BasicBlockV1", [8, 8, 16, 32, 64], True, 16, 0.01),
    (1, "BottleneckV1", [8, 16, 32, 64, 128], True, 16, 0.01),
    (2, "BasicBlockV2", [8, 8, 16, 32, 64], True, 16, 0.01),
    (2, "BottleneckV2", [8, 16, 32, 64, 128], True, 16, 0.01),
    # the 7x7/2 stem, BN, ReLU and the 3x3/2 max pool (lr: see the module
    # docstring)
    (1, "BottleneckV1", [8, 16, 32, 64, 128], False, 64, 1e-3),
]


@pytest.mark.parametrize("version,block,channels,thumbnail,image,lr",
                         RESNETS)
def test_resnet_matches_reference(version, block, channels, thumbnail,
                                  image, lr):
    """The stock ResNets, width-reduced: stages of [2, 1, 1, 1] blocks
    (a stage's first block downsamples where the width changes)."""
    layers = [2, 1, 1, 1]
    _, tnet, tstep = check_family(
        lambda: _resnet(jres, version, block, layers, channels,
                        thumbnail=thumbnail),
        lambda: _resnet(tres, version, block, layers, channels,
                        thumbnail=thumbnail),
        (2, 3, image, image), lr=lr)
    if version == 2:
        # the input BN has neither scale nor shift: both in the aux set
        bn0 = tnet.features[0]
        assert not bn0.gamma.requires_grad and not bn0.beta.requires_grad
        assert any(t is bn0.gamma for t in tstep._aux)
        assert not any(t is bn0.gamma for t in tstep._gp)


#: values of the JAX package's collect_params() (parameters and running
#: stats) of each zoo net at 1000 classes, shapes resolved at 224 px
#: (Inception 299)
REFERENCE_COUNTS = {
    "alexnet": 61100840, "densenet121": 8062504, "densenet161": 28900936,
    "densenet169": 14307880, "densenet201": 20242984,
    "inception_v3": 23869000, "mobilenet0_25": 475544,
    "mobilenet0_5": 1342536, "mobilenet0_75": 2601976,
    "mobilenet1_0": 4253864, "mobilenet_v2_0_25": 1526856,
    "mobilenet_v2_0_5": 1983104, "mobilenet_v2_0_75": 2653864,
    "mobilenet_v2_1_0": 3539136, "resnet101_v1": 44695144,
    "resnet101_v2": 44639412, "resnet152_v1": 60404072,
    "resnet152_v2": 60329140, "resnet18_v1": 11699112,
    "resnet18_v2": 11695796, "resnet34_v1": 21814696,
    "resnet34_v2": 21811380, "resnet50_v1": 25629032,
    "resnet50_v2": 25595060, "squeezenet1_0": 1248424,
    "squeezenet1_1": 1235496, "vgg11": 132863336, "vgg11_bn": 132874344,
    "vgg13": 133047848, "vgg13_bn": 133059624, "vgg16": 138357544,
    "vgg16_bn": 138374440, "vgg19": 143667240, "vgg19_bn": 143689256,
}


def _port_count(name):
    net = tvision.get_model(name, device="cpu")
    img = 299 if name.startswith("inception") else 224
    gluon.shape_init(net, (1, 3, img, img))
    return sum(t.numel() for _, t in convert.ordered_tensors(net))


def test_registry_covers_the_reference():
    assert sorted(tvision._models) == sorted(jvision._models) == \
        sorted(REFERENCE_COUNTS)
    with pytest.raises(ValueError, match="not found"):
        tvision.get_model("resnet9_v1")


@pytest.mark.parametrize("name", sorted(REFERENCE_COUNTS))
def test_get_model_parameter_count(name):
    assert _port_count(name) == REFERENCE_COUNTS[name]


def test_reference_counts_are_the_reference():
    """One net counted live on the JAX side (v2: gamma/beta without
    gradient included)."""
    net = jvision.get_model("resnet18_v2")
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1, 3, 224, 224))
    count = sum(int(np.prod(p.shape))
                for p in net.collect_params().values())
    assert count == REFERENCE_COUNTS["resnet18_v2"] == \
        _port_count("resnet18_v2")


def test_stock_resnet50_structure():
    """The default model of the trainer: 53 stock BatchNorms, no ghost-BN
    layer, one max pool."""
    net = tres.resnet50_v1(device="cpu")
    gluon.shape_init(net, (1, 3, 224, 224))
    mods = list(net.modules())
    assert sum(isinstance(m, gluon.nn.BatchNorm) for m in mods) == 53
    assert not any(isinstance(m, tres.GhostBNReLU) for m in mods)
    assert sum(isinstance(m, gluon.nn.MaxPool2D) for m in mods) == 1
