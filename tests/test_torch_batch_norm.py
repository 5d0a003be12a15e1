"""Stock batch norm and dropout of the port against the JAX package's.

The op (``ops.nn.batch_norm``) against ``ops/nn.py`` ``_batch_norm``:
forward in training (batch statistics) and inference (moving stats),
with and without ``fix_gamma`` and ``use_global_stats``, over axis 1 and
the last axis, in f32 and bf16; its gradients (data, gamma, beta)
against ``jax.grad`` of the same function; the running update against
``_batch_norm_stats`` + ``_batch_norm_aux_update``.  The layer
(``gluon.nn.BatchNorm``, deferred width) against the reference's gluon
layer after one training forward, its running stats included.  A
hand-computed case pins the biased variance and MXNet's momentum
direction (``m * old + (1 - m) * batch``).

Dropout (``ops.nn.dropout``, ``gluon.nn.Dropout``): the kept entries
scaled by ``1 / (1 - p)``, a mask shared along ``axes``, a keep rate
near ``1 - p``, the same draws after ``random.seed``, identity outside
training.  JAX's mask comes from ``jax.random`` and cannot be matched
draw for draw, so dropout is held to its definition.

Tolerances: f32 outputs and gradients 1e-5 absolute (inputs of unit
scale; the two sides compute the variance in another order), running
stats 1e-6; bf16 outputs one bf16 step (2^-7 relative, 0.04 absolute at
the inputs' scale of 4), bf16 running stats 1e-5 (both accumulate in
f32 from the same bf16 values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, nd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.ops import nn as jops

from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch.ops import nn as tops

EPS = 1e-3


def _data(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    c = shape[1]
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(size=c).astype(np.float32)
    mm = rng.normal(size=c).astype(np.float32) * 0.1
    mv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return x, gamma, beta, mm, mv


def _jax_bn(x, gamma, beta, mm, mv, training, **kw):
    ctx = autograd.train_mode() if training else autograd.predict_mode()
    with ctx:
        return jops._batch_norm(x, gamma, beta, mm, mv, **kw)


def _to_dtype(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training,fix_gamma,use_global_stats", [
    (True, False, False), (True, True, False), (True, False, True),
    (False, False, False)])
def test_batch_norm_op_matches_reference(dtype, training, fix_gamma,
                                         use_global_stats):
    x, gamma, beta, mm, mv = _data((4, 3, 5, 6))
    kw = dict(eps=EPS, fix_gamma=fix_gamma,
              use_global_stats=use_global_stats)
    want = np.asarray(_jax_bn(_to_dtype(x, dtype), gamma, beta, mm, mv,
                              training, **kw).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tops.batch_norm(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(gamma), torch.from_numpy(beta),
                          torch.from_numpy(mm), torch.from_numpy(mv),
                          training=training, **kw)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0.04)


@pytest.mark.parametrize("axis", [1, -1])
def test_batch_norm_axis(axis):
    x, gamma, beta, mm, mv = _data((4, 3, 5, 6))
    if axis == -1:
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    want = np.asarray(_jax_bn(x, gamma, beta, mm, mv, True, eps=EPS,
                              fix_gamma=False, axis=axis % 4))
    got = tops.batch_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                          torch.from_numpy(beta), torch.from_numpy(mm),
                          torch.from_numpy(mv), eps=EPS, fix_gamma=False,
                          axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    mean, var = tops.batch_norm_stats(torch.from_numpy(x), axis=axis)
    jm, jv = jops._batch_norm_stats(x, axis=axis % 4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_gradient_matches_reference(fix_gamma):
    x, gamma, beta, mm, mv = _data((4, 3, 5, 6), seed=1)
    g = np.random.RandomState(2).normal(size=x.shape).astype(np.float32)

    def f(x_, gamma_, beta_):
        out = _jax_bn(x_, gamma_, beta_, mm, mv, True, eps=EPS,
                      fix_gamma=fix_gamma)
        return jnp.sum(out * g)

    jgx, jgg, jgb = jax.grad(f, argnums=(0, 1, 2))(x, gamma, beta)
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    out = tops.batch_norm(tx, tg, tb, torch.from_numpy(mm),
                          torch.from_numpy(mv), eps=EPS, fix_gamma=fix_gamma)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    if fix_gamma:
        assert tg.grad is None or not tg.grad.any()
    else:
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_running_update_matches_reference(dtype):
    x, gamma, beta, mm, mv = _data((8, 4, 3, 3), seed=3)
    xj = _to_dtype(x, dtype)
    upd = jops._batch_norm_aux_update([xj, None, None, mm, mv], None,
                                      momentum=0.9)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    _, bm, bv = tops.batch_norm(xt, torch.from_numpy(gamma),
                                torch.from_numpy(beta), torch.from_numpy(mm),
                                torch.from_numpy(mv), eps=EPS,
                                fix_gamma=False, output_mean_var=True)
    assert bm.dtype == bv.dtype == torch.float32
    rm, rv = tops.batch_norm_aux_update(torch.from_numpy(mm),
                                        torch.from_numpy(mv), bm, bv, 0.9)
    tol = 1e-6 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(rm.numpy(), np.asarray(upd[3]), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(rv.numpy(), np.asarray(upd[4]), rtol=0,
                               atol=tol)


def test_biased_variance_and_momentum_direction():
    """One channel holding 1, 2, 3, 4: mean 2.5, biased variance 1.25
    (the unbiased 5/3 is what torch.nn.BatchNorm2d would track); from
    running stats (0, 1) at momentum 0.9 the update is
    (0.9 * 0 + 0.1 * 2.5, 0.9 * 1 + 0.1 * 1.25) = (0.25, 1.025)."""
    layer = tgluon.nn.BatchNorm(device="cpu")
    layer.train()
    x = torch.tensor([1.0, 2.0, 3.0, 4.0]).reshape(4, 1, 1, 1)
    out = layer(x)
    assert layer.running_mean.tolist() == pytest.approx([0.25], abs=1e-7)
    assert layer.running_var.tolist() == pytest.approx([1.025], abs=1e-7)
    want = (x - 2.5) / np.sqrt(1.25 + 1e-5)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), rtol=0,
                               atol=1e-6)
    layer.eval()
    before = layer.running_mean.clone()
    layer(x)
    assert torch.equal(layer.running_mean, before)


@pytest.mark.parametrize("kwargs", [{}, {"scale": False, "center": False},
                                    {"use_global_stats": True},
                                    {"momentum": 0.5, "epsilon": 1e-3}])
def test_batch_norm_layer_matches_reference(kwargs):
    """The layer with a deferred width, one training forward and backward
    on both sides: outputs, data and gamma/beta gradients, running
    stats."""
    x, gamma, beta, mm, mv = _data((4, 3, 5, 6), seed=4)
    jl = jgluon.nn.BatchNorm(**kwargs)
    jl.initialize()
    jl.shape_init(x.shape)
    tl = tgluon.nn.BatchNorm(device="cpu", **kwargs)
    tgluon.shape_init(tl, x.shape)
    assert tl.gamma.shape == (3,) and tl.running_var.shape == (3,)
    for jp, tp, v in zip(jl.collect_params().values(),
                         (tl.gamma, tl.beta, tl.running_mean, tl.running_var),
                         (gamma, beta, mm, mv)):
        jp.set_data(nd.array(v))
        with torch.no_grad():
            tp.copy_(torch.from_numpy(v))
    assert tl.gamma.requires_grad == kwargs.get("scale", True)
    assert tl.beta.requires_grad == kwargs.get("center", True)
    g = np.random.RandomState(5).normal(size=x.shape).astype(np.float32)
    xj = nd.array(x)
    xj.attach_grad()
    with autograd.record():
        jo = jl(xj)
        jloss = (jo * nd.array(g)).sum()
    jloss.backward()
    tl.train()
    xt = torch.from_numpy(x).requires_grad_()
    to = tl(xt)
    (to * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.asnumpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.asnumpy(), rtol=0,
                               atol=1e-5)
    for jp, tp in zip(jl.collect_params().values(),
                      (tl.gamma, tl.beta, tl.running_mean, tl.running_var)):
        np.testing.assert_allclose(tp.detach().numpy(), jp.data().asnumpy(),
                                   rtol=0, atol=1e-6, err_msg=jp.name)
        if jp.grad_req != "null":
            np.testing.assert_allclose(tp.grad.numpy(), jp.grad().asnumpy(),
                                       rtol=0, atol=1e-5, err_msg=jp.name)
        else:
            assert tp.grad is None


def test_dropout_definition():
    x = torch.ones(64, 8, 16, 16)
    gen = torch.Generator().manual_seed(0)
    y = tops.dropout(x, 0.25, axes=(2, 3), generator=gen)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    # one draw per (n, c), shared along the dropped axes
    assert torch.equal(kept, kept[:, :, :1, :1].expand_as(kept))
    assert abs(kept[:, :, 0, 0].float().mean().item() - 0.75) < 0.05
    assert tops.dropout(x, 0.25, training=False) is x
    assert tops.dropout(x, 0.0) is x


def test_dropout_layer_draws_from_the_seeded_generator():
    layer = tgluon.nn.Dropout(0.5)
    x = torch.ones(1000)
    trandom.seed(7)
    a = layer(x)
    trandom.seed(7)
    b = layer(x)
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    layer.eval()
    assert layer(x) is x


def test_reference_dropout_scaling_agrees():
    """The reference's kept entries carry the same 1 / (1 - p) scale."""
    mx.random.seed(0)
    x = nd.ones((1000,))
    with autograd.train_mode():
        y = nd.Dropout(x, p=0.5).asnumpy()
    assert set(np.unique(y).tolist()) == {0.0, 2.0}
