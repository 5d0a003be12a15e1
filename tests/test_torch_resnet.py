"""The port's ghost-BN ResNet v1 against the JAX package's, on the CPU.

Both nets are the small ``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[16, 32, 64, 128, 256], classes=10, ghost_bn=2)``; the JAX net is
initialized and its weights are carried into the port's by position
(``convert.params_from_jax``).  One training forward and backward of
the same f32 batch (4 x 3 x 64 x 64, made with numpy) must give the same
logits, loss, parameter gradients and running stats.  The JAX side runs
its Pallas kernels in interpret mode, as its own tests do.  (At 32 px
the last stage is 1 x 1, a ghost group of 2 holds 2 values a channel,
and normalizing them amplifies f32 rounding a thousandfold; 64 px keeps
the comparison about the port, not about that conditioning.)

Tolerances (f32, sums taken in another order on the two sides): 1e-5
absolute for the running stats, 1e-4 absolute for the logits and the
loss (17 layers deep) and for the gradients.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, nd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres

from incubator_mxnet_tpu_torch import convert
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

LAYERS = [1, 1, 1, 1]
CHANNELS = [16, 32, 64, 128, 256]
IMAGE = 64


def build_pair(seed=0):
    """(jax_net, port_net) with the same weights, both f32 on the CPU."""
    mx.random.seed(seed)
    jnet = jres.ResNetV1(jres.BottleneckV1, LAYERS, CHANNELS, classes=10,
                         ghost_bn=2)
    jnet.initialize(init=mx.init.Xavier())
    jnet.shape_init((1, 3, IMAGE, IMAGE))
    tnet = tres.ResNetV1(tres.BottleneckV1, LAYERS, CHANNELS, classes=10,
                         ghost_bn=2, device="cpu")
    convert.params_from_jax(tnet, [p.data().asnumpy()
                                   for p in jnet.collect_params().values()])
    return jnet, tnet


def batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(4, 3, IMAGE, IMAGE)).astype(np.float32)
    y = rng.randint(0, 10, size=4).astype(np.float32)
    return x, y


def test_resnet_forward_backward_matches_reference():
    jnet, tnet = build_pair()
    x, y = batch()
    params = list(jnet.collect_params().values())
    with autograd.record():
        jout = jnet(nd.array(x, dtype="float32"))
        jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jout, nd.array(y, dtype="float32")).mean()
    jloss.backward()

    tnet.train()
    tout = tnet(torch.from_numpy(x))
    tloss_v = tloss.SoftmaxCrossEntropyLoss()(tout, torch.from_numpy(y)).mean()
    tloss_v.backward()

    np.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tloss_v.item(), float(jloss.asnumpy()),
                               rtol=0, atol=1e-4)
    tensors = convert.ordered_tensors(tnet)
    assert len(tensors) == len(params)
    n_grads = 0
    for p, (name, t) in zip(params, tensors):
        if p.grad_req == "null":
            # running stats after one training forward
            np.testing.assert_allclose(t.numpy(), p.data().asnumpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            continue
        np.testing.assert_allclose(t.grad.numpy(), p.grad().asnumpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
        n_grads += 1
    assert n_grads == len(list(tnet.parameters()))


def test_resnet_eval_uses_running_stats():
    jnet, tnet = build_pair(seed=1)
    x, _ = batch(seed=1)
    jout = jnet(nd.array(x, dtype="float32"))   # not recording: eval mode
    tnet.eval()
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), jout.asnumpy(), rtol=0,
                               atol=1e-4)


def test_resnet50_structure():
    """53 ghost-BN layers (stem, 16 blocks x 3, 4 downsamples), the dual
    exits everywhere but the last block, donation on the 4 downsample
    exits, and the parameter count of the reference."""
    net = tres.resnet50_v1(classes=1000, ghost_bn=16, device="cpu")
    bns = [m for m in net.modules() if isinstance(m, tres.GhostBNReLU)]
    assert len(bns) == 53
    exits = [b.gbn3 for b in net.modules()
             if isinstance(b, tres.BottleneckV1)]
    assert len(exits) == 16
    assert [e._dual_out for e in exits] == [True] * 15 + [False]
    assert sum(e._donate_residual for e in exits) == 4
    assert sum(isinstance(m, tres.GhostBN) for m in bns) == 4
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == 25557032


def test_convert_copies_and_checks():
    _, tnet = build_pair(seed=2)
    arrays = convert.params_to_numpy(tnet)
    with torch.no_grad():
        tnet.output.bias.add_(1.0)
    assert not np.array_equal(arrays[-1], tnet.output.bias.detach().numpy())
    convert.params_from_jax(tnet, arrays)
    np.testing.assert_array_equal(arrays[-1], tnet.output.bias.detach().numpy())
    with pytest.raises(ValueError, match="arrays for"):
        convert.params_from_jax(tnet, arrays[:-1])
    with pytest.raises(ValueError, match="has shape"):
        convert.params_from_jax(tnet, arrays[:-1] + [np.zeros(3)])


def test_initializer_rules_and_xavier_bound():
    """Name rules of the reference Initializer (gamma/running_var ones,
    beta/bias/running_mean zeros) and Xavier's uniform bound
    sqrt(3 / ((fan_in + fan_out) / 2)) with receptive-field fans."""
    from incubator_mxnet_tpu_torch import initializer

    net = tres.ResNetV1(tres.BottleneckV1, LAYERS, CHANNELS, classes=10,
                        ghost_bn=2, device="cpu")
    initializer.initialize(net, generator=torch.Generator().manual_seed(0))
    for name, t in convert.ordered_tensors(net):
        t = t.detach()
        if name.endswith(("gamma", "running_var")):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.endswith(("beta", "bias", "running_mean")):
            assert torch.equal(t, torch.zeros_like(t)), name
        else:
            rf = int(np.prod(t.shape[2:])) if t.dim() > 2 else 1
            bound = np.sqrt(3.0 / ((t.shape[0] + t.shape[1]) * rf / 2.0))
            assert float(t.abs().max()) <= bound, name
            assert float(t.abs().max()) > 0.5 * bound, name
