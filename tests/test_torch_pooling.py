"""The pooling types and activations of the vision zoo (ROADMAP A3c)
against the JAX package's ``ops/nn.py``, and K3's routing at every max
pool of the zoo.

``ops.nn.pooling`` against ``_pooling``: ceil mode
(``pooling_convention="full"``) for max and average pooling, average
pooling with and without ``count_include_pad``, sum pooling, global
max/avg/sum; forward and input gradient (``jax.vjp``), f32 and
bf16.  ``ops.nn.activation`` (relu, sigmoid, tanh, softrelu, softsign)
and the port's ``clip`` (MobileNet's relu6) against ``_activation`` and
``_clip``, with gradients.

K3's routing: ``chip_smoke.ZOO_POOLS`` lists every distinct max pool of
the zoo's 34 models; the table must equal what the models' own
``MaxPool2D`` layers see at 224 px (Inception 299), built on ``meta``
tensors (shapes only), and each entry,
scaled down to batch 2 and 4 channels, must take exactly one K3 launch
down the card branch (``_on_card`` patched, a recording launcher in
``_kernels.KERNELS``) with the geometry the kernel needs.

C4, max pooling that the reference computes outside its Pallas kernel:
windows of 1 slot and of 144 slots (the index plane holds 2 to 127),
and f64, f16 and int8, forward and first-argmax gradient against
``_pooling`` on the CPU; routed down the card branch, those windows and
int8 take no K3 launch (stock torch ops: ``maxpool_idx._maxpool_plain``),
while every window of 2 to 127 slots in f32, bf16, f16 or f64, where
the reference's ``plan`` places its kernel, launches K3.

Tolerances: max pooling exact (the reference's first-argmax rule);
average/sum and the activations 1e-6 absolute in f32 (sums of 9
terms in another order), one bf16 step (2^-7 relative) in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu.ops.math as jmath
import incubator_mxnet_tpu.ops.nn as jops

from incubator_mxnet_tpu_torch import _kernels, context, gluon
from incubator_mxnet_tpu_torch.gluon.block import F
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn import MaxPool2D
from incubator_mxnet_tpu_torch.ops import nn as tops
from incubator_mxnet_tpu_torch.parallel import maxpool_idx


def _x(shape, seed=0, relu=False):
    rng = np.random.RandomState(seed)
    x = np.round(rng.normal(size=shape) * 4) / 4
    return (np.maximum(x, 0) if relu else x).astype(np.float32)


def _compare(kw, shape, dtype, exact=False, seed=0):
    x = _x(shape, seed, relu=kw.get("pool_type") == "max")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jout, vjp = jax.vjp(lambda a: jops._pooling(a, **kw),
                        jnp.asarray(x, jdt))
    g = np.random.RandomState(seed + 1).normal(size=jout.shape) \
        .astype(np.float32)
    (jdx,) = vjp(jnp.asarray(g, jdt))
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    tout = tops.pooling(xt, **kw)
    tout.backward(torch.from_numpy(g).to(xt.dtype))
    assert tuple(tout.shape) == jout.shape and tout.dtype == xt.dtype
    pairs = [(tout.detach().float().numpy(), np.asarray(jout, np.float32)),
             (xt.grad.float().numpy(), np.asarray(jdx, np.float32))]
    for got, want in pairs:
        if exact:
            np.testing.assert_array_equal(got, want)
        elif dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kernel,stride,pad", [
    ((2, 3, 9, 9), (3, 3), (2, 2), (0, 0)),      # SqueezeNet's pools
    ((2, 3, 10, 10), (3, 3), (2, 2), (1, 1)),
    ((2, 3, 7, 8), (2, 2), (2, 2), (0, 0)),
])
def test_ceil_mode_max_pool(dtype, shape, kernel, stride, pad):
    _compare(dict(kernel=kernel, pool_type="max", stride=stride, pad=pad,
                  pooling_convention="full"), shape, dtype, exact=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("kernel,stride,pad,convention", [
    ((3, 3), (1, 1), (1, 1), "valid"),           # Inception's branches
    ((2, 2), (2, 2), (0, 0), "valid"),           # DenseNet's transitions
    ((3, 3), (2, 2), (1, 1), "full"),
    ((8, 8), (8, 8), (0, 0), "valid"),           # Inception's last pool
])
def test_avg_pool(dtype, count_include_pad, kernel, stride, pad, convention):
    _compare(dict(kernel=kernel, pool_type="avg", stride=stride, pad=pad,
                  pooling_convention=convention,
                  count_include_pad=count_include_pad),
             (2, 3, 9, 9) if kernel != (8, 8) else (2, 3, 8, 8), dtype)


def test_sum_pool():
    _compare(dict(kernel=(3, 3), pool_type="sum", stride=(2, 2),
                  pad=(1, 1)), (2, 3, 9, 9), "float32")


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pool(pool_type):
    _compare(dict(kernel=(1, 1), pool_type=pool_type, global_pool=True),
             (2, 3, 5, 7), "float32", exact=pool_type == "max", seed=3)


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh", "softrelu",
                                      "softsign"])
def test_activation_matches_reference(act_type):
    x = np.random.RandomState(5).normal(size=(4, 7)).astype(np.float32) * 3
    g = np.random.RandomState(6).normal(size=x.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a: jops._activation(a, act_type),
                        jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    tout = tops.activation(xt, act_type)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="act_type"):
        tops.activation(xt, "gelu")


def test_relu6_clip_matches_reference():
    """MobileNet's ``HybridLambda(lambda F, x: F.clip(x, 0, 6))`` over the
    port's registered ``clip``, away from the two edges (where the
    reference's gradient splits a tie)."""
    x = np.random.RandomState(7).uniform(-3, 9, (64,)).astype(np.float32)
    g = np.random.RandomState(8).normal(size=x.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a: jmath._clip(a, 0, 6), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    layer = gluon.nn.HybridLambda(lambda F_, a: F_.clip(a, 0, 6))
    out = layer(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))
    assert F.Concat(xt[:2], xt[2:4], dim=0).shape == (4,)


def _pool_table(monkeypatch):
    """What the zoo's MaxPool2D layers see, as ZOO_POOLS' entries.  The
    nets are built on ``meta`` tensors (shapes without data, as the
    symbolic layer's shape inference runs): resolving their widths then
    runs no arithmetic.  The port refuses devices other than the card and
    the CPU, so the test lets ``context.resolve`` pass ``meta`` through."""
    real = context.resolve

    def resolve(device=None):
        if device is not None and torch.device(device).type == "meta":
            return torch.device("meta")
        return real(device)

    monkeypatch.setattr(context, "resolve", resolve)
    seen = set()
    for name in sorted(vision._models):
        net = vision.get_model(name, device="meta")
        img = 299 if name.startswith("inception") else 224

        def hook(m, args):
            kw = m._kwargs
            seen.add((tuple(args[0].shape[1:]), kw["kernel"][0],
                      kw["stride"][0], kw["pad"][0],
                      kw["pooling_convention"] == "full"))

        for m in net.modules():
            if isinstance(m, MaxPool2D):
                m.register_forward_pre_hook(hook)
        gluon.shape_init(net, (1, 3, img, img))
    return seen


def test_zoo_pool_table_is_the_models(monkeypatch):
    table = {entry[1:] for entry in chip_smoke.ZOO_POOLS}
    assert len(table) == len(chip_smoke.ZOO_POOLS)
    assert table == _pool_table(monkeypatch)


class _Recorder:
    def __init__(self):
        self.calls = []

    def launch(self, device, *args):
        self.calls.append(args)


@pytest.mark.parametrize("entry", chip_smoke.ZOO_POOLS,
                         ids=lambda e: "%s-%dx%d" % (e[0], e[1][1], e[1][2]))
def test_zoo_pool_takes_one_k3_launch(monkeypatch, entry):
    """The pooling op at a zoo shape (batch 2, 4 channels) goes down the
    card branch to one K3 launch, with the kernel's geometry: (N, C, H,
    W, OH, OW, kh, kw, sh, sw, ph, pw), the high edge implied by OH/OW."""
    _, (_, h, w), k, s, p, ceil = entry
    monkeypatch.setattr(maxpool_idx, "_on_card", lambda t: True)
    rec = _Recorder()
    monkeypatch.setitem(_kernels.KERNELS, "maxpool_idx_fwd", rec)
    x = torch.zeros(2, 4, h, w)
    out = tops.pooling(x, kernel=(k, k), pool_type="max", stride=(s, s),
                       pad=(p, p),
                       pooling_convention="full" if ceil else "valid")
    window, strides, padding = chip_smoke.zoo_pool_cfg(k, s, p, ceil)
    oh, ow = maxpool_idx.check_shape(x.shape, window, strides, padding)
    assert tuple(out.shape) == (2, 4, oh, ow)
    (args,) = rec.calls
    # (dtype, x, out, idx, N, C, H, W, OH, OW, kh, kw, sh, sw, ph, pw)
    assert args[4:] == (2, 4, h, w, oh, ow, k, k, s, s, p, p)
    want_oh = -(-(h + 2 * p - k) // s) + 1 if ceil else \
        (h + 2 * p - k) // s + 1
    assert oh == want_oh


@pytest.mark.parametrize("dtype", ["float64", "float16", "int8"])
@pytest.mark.parametrize("kernel,stride", [((1, 1), (1, 1)),
                                           ((12, 12), (1, 1)),
                                           ((2, 2), (2, 2))])
def test_max_pool_outside_k3_matches_reference(dtype, kernel, stride):
    """C4: the port computes every max pool the reference computes, bit
    for bit, gradient included (ints have none)."""
    x = np.round(np.random.RandomState(9).normal(size=(2, 3, 16, 16)) * 4)
    x = np.maximum(x, 0).astype(dtype)
    kw = dict(kernel=kernel, pool_type="max", stride=stride)
    floating = dtype != "int8"
    if floating:
        jout, vjp = jax.vjp(lambda a: jops._pooling(a, **kw), jnp.asarray(x))
        g = np.random.RandomState(10).normal(size=jout.shape).astype(dtype)
        (jdx,) = vjp(jnp.asarray(g))
    else:
        jout = jops._pooling(jnp.asarray(x), **kw)
    xt = torch.from_numpy(x).requires_grad_(floating)
    tout = tops.pooling(xt, **kw)
    assert tout.dtype == xt.dtype and tuple(tout.shape) == jout.shape
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    if floating:
        tout.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("dtype,kernel,launches", [
    (torch.float32, (2, 2), 1), (torch.bfloat16, (2, 2), 1),
    (torch.float32, (1, 1), 0), (torch.float32, (12, 12), 0),
    (torch.float32, (11, 11), 1), (torch.float16, (2, 2), 1),
    (torch.float64, (2, 2), 1), (torch.float16, (12, 12), 0),
    (torch.int8, (2, 2), 0),
])
def test_card_routes_max_pool_as_the_reference_plans(monkeypatch, dtype,
                                                     kernel, launches):
    """Down the card branch, K3 takes the windows of 2 to 127 slots in
    every floating dtype (121 slots: the largest square), and stock torch
    ops the rest, with no retry."""
    monkeypatch.setattr(maxpool_idx, "_on_card", lambda t: True)
    rec = _Recorder()
    monkeypatch.setitem(_kernels.KERNELS, "maxpool_idx_fwd", rec)
    x = torch.zeros(2, 3, 16, 16, dtype=dtype)
    out = tops.pooling(x, kernel=kernel, pool_type="max", stride=(1, 1))
    assert tuple(out.shape) == (2, 3, 17 - kernel[0], 17 - kernel[1])
    assert len(rec.calls) == launches
