"""The space-to-depth stem (``resnet._S2DStemConv``, ROADMAP A4b).

It computes the 7x7 stride-2 pad-3 convolution as a 4x4 stride-1
convolution over the 2x2 packing of its padded input, from a weight of
the plain stem's (C, 3, 7, 7) shape.  Held against:

- ``F.conv2d`` with the same weight (the plain stem), f32 and f64;
- the JAX package's ``_S2DStemConv`` with the same weight, forward and
  the gradients of input and weight;
- ``resnet50_v1(s2d_stem=True)`` against ``resnet50_v1()`` loaded with
  the same weights (the stem's weight keeps its shape, so the nets load
  the same arrays by position), eval forward.

Tolerances: f64 1e-12, f32 1e-5 absolute (sums of 147 products at unit
scale in another order), the nets' logits 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres

from incubator_mxnet_tpu_torch import convert, gluon, initializer
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres


def _data(n=2, c=3, h=20, w=24, o=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n, c, h, w)).astype(np.float32),
            rng.normal(size=(o, c, 7, 7)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_s2d_stem_is_the_7x7_stride_2_conv(dtype):
    x, w = _data()
    stem = tres._S2DStemConv(8, device="cpu").to(dtype)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(dtype)
    got = stem(xt)
    want = F.conv2d(xt, stem.weight, stride=2, padding=3)
    assert got.shape == want.shape == (2, 8, 10, 12)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=tol)


def test_s2d_stem_matches_reference():
    x, w = _data(seed=1)
    g = np.random.RandomState(2).normal(size=(2, 8, 10, 12)) \
        .astype(np.float32)
    jstem = jres._S2DStemConv(8)
    jstem.initialize()
    jstem.shape_init(x.shape)

    def f(x_, w_):
        from incubator_mxnet_tpu.ndarray import NDArray
        from incubator_mxnet_tpu import ndarray as F_

        return jnp.sum(jstem.hybrid_forward(F_, NDArray(x_),
                                            NDArray(w_))._data * g)

    (jval, (jgx, jgw)) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    stem = tres._S2DStemConv(8, device="cpu")
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(w))
    xt = torch.from_numpy(x).requires_grad_()
    val = (stem(xt) * torch.from_numpy(g)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(stem.weight.grad.numpy(), np.asarray(jgw),
                               rtol=0, atol=1e-4)


def test_resnet50_s2d_stem_equals_plain_stem():
    shape = (1, 3, 64, 64)
    plain = tres.resnet50_v1(classes=10, device="cpu")
    s2d = tres.resnet50_v1(classes=10, s2d_stem=True, device="cpu")
    for net in (plain, s2d):
        gluon.shape_init(net, shape)
    initializer.initialize(plain, generator=torch.Generator().manual_seed(0))
    convert.params_from_jax(s2d, convert.params_to_numpy(plain))
    assert s2d.features[0].weight.shape == (64, 3, 7, 7)
    x = torch.from_numpy(np.random.RandomState(3).normal(size=shape)
                         .astype(np.float32))
    plain.eval()
    s2d.eval()
    with torch.no_grad():
        np.testing.assert_allclose(s2d(x).numpy(), plain(x).numpy(), rtol=0,
                                   atol=1e-4)
