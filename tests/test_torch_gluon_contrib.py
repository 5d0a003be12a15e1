"""The port's ``gluon.contrib`` layers and cells and its
``_contrib_DeformableConvolution`` against the JAX package's, on the CPU,
with the reference's weights carried across (by name,
``convert.params_from_gluon``): the cases of ``tests/test_gluon_contrib.py``
and the two deformable cases of ``tests/test_contrib_tail2.py``.

Outputs and gradients are held within 1e-5 (``rtol`` and ``atol``): both
sides compute in float32 and differ by the order of their sums.  The
variational dropout masks come from the port's generator, so they are
held to the property the reference's test checks (one mask for every
step until ``reset()``) and rate 0 to the base cell.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import contrib as jcontrib
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.gluon import contrib as tcontrib
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon import rnn as trnn
from incubator_mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, low=-1.0, high=1.0):
    return np.random.RandomState(seed).uniform(low, high, shape).astype(
        np.float32)


def _build(make):
    """``make(jmx-side modules)`` and ``make(port-side modules)`` (the
    latter on the CPU)."""
    j = make(jcontrib, jnn, jrnn)
    with context.device_scope("cpu"):
        t = make(tcontrib, tnn, trnn)
    return j, t


def _carry(jblock, tblock):
    convert.params_from_gluon(tblock, {
        k: p.data().asnumpy() for k, p in jblock.collect_params().items()})


def _grads(block):
    return {k: p.grad().asnumpy() for k, p in zip(
        convert.canonical_names(list(block.collect_params().keys())),
        block.collect_params().values()) if p.grad_req != "null"}


def _same_grads(jblock, tblock):
    gj, gt = _grads(jblock), _grads(tblock)
    assert sorted(gj) == sorted(gt)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], err_msg=k, **TOL)


# -------------------------------------------------------------------- nn
@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 2, (2, 6, 4)),
    ("PixelShuffle2D", (2, 3), (1, 12, 3, 5)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 2)),
])
def test_pixel_shuffle_matches_reference(cls, factor, shape):
    x = _rand(shape, 0)
    want = getattr(jcontrib.nn, cls)(factor)(jmx.nd.array(x)).asnumpy()
    got = getattr(tcontrib.nn, cls)(factor)(tmx.nd.array(x, ctx=CPU))
    np.testing.assert_array_equal(got.asnumpy(), want)


@pytest.mark.parametrize("hybrid", [True, False])
def test_concurrent_and_identity_match_reference(hybrid):
    def make(c, nn, _):
        net = (c.nn.HybridConcurrent if hybrid else c.nn.Concurrent)(axis=1)
        net.add(nn.Dense(4, in_units=3))
        net.add(c.nn.Identity())
        net.add(nn.Dense(2, in_units=3, activation="tanh"))
        return net

    jnet, tnet = _build(make)
    jnet.initialize()
    _carry(jnet, tnet)
    x = _rand((5, 3), 1)
    with jmx.autograd.record():
        yj = jnet(jmx.nd.array(x))
        (yj * yj).sum().backward()
    with tmx.autograd.record():
        yt = tnet(tmx.nd.array(x, ctx=CPU))
        (yt * yt).sum().backward()
    assert yt.shape == (5, 9)
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), **TOL)
    _same_grads(jnet, tnet)


def test_sync_batch_norm_equals_batch_norm_and_reference():
    with context.device_scope("cpu"):
        sbn = tcontrib.nn.SyncBatchNorm(in_channels=3, num_devices=4)
        bn = tnn.BatchNorm(in_channels=3)
    jsbn = jcontrib.nn.SyncBatchNorm(in_channels=3, num_devices=4)
    jsbn.initialize()
    jsbn.shape_init((2, 3, 4, 4))
    _carry(jsbn, sbn)
    convert.params_from_jax(bn, [p.data().asnumpy()
                                 for p in jsbn.collect_params().values()])
    x = _rand((8, 3, 4, 4), 2, 0.0, 2.0)
    outs = []
    for b in (sbn, bn):
        with tmx.autograd.record():
            outs.append(b(tmx.nd.array(x, ctx=CPU)).asnumpy())
    with jmx.autograd.record():
        want = jsbn(jmx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], want, **TOL)
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(getattr(sbn, k).numpy(),
                                      getattr(bn, k).numpy())
    # inference: the moved running statistics
    np.testing.assert_allclose(
        sbn(tmx.nd.array(x, ctx=CPU)).asnumpy(),
        jsbn(jmx.nd.array(x)).asnumpy(), **TOL)


def test_sparse_embedding_dense_gradient_matches_reference():
    jemb, temb = _build(lambda c, *_: c.nn.SparseEmbedding(10, 4))
    jemb.initialize()
    _carry(jemb, temb)
    idx = np.array([[1, 3, 3], [7, 0, 1]], np.float32)
    with jmx.autograd.record():
        yj = jemb(jmx.nd.array(idx))
        (yj * yj).sum().backward()
    with tmx.autograd.record():
        yt = temb(tmx.nd.array(idx, ctx=CPU))
        (yt * yt).sum().backward()
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), **TOL)
    _same_grads(jemb, temb)
    g = list(_grads(temb).values())[0]
    assert not g[[2, 4, 5, 6, 8, 9]].any() and g[[0, 1, 3, 7]].any()


# ------------------------------------------------------------------- rnn
def test_variational_dropout_mask_fixed_across_time():
    tmx.random.seed(0)
    with context.device_scope("cpu"):
        base = trnn.RNNCell(6, activation="sigmoid", input_size=6)
        cell = tcontrib.rnn.VariationalDropoutCell(base, drop_outputs=0.5)
    cell.initialize()
    x = tmx.nd.array(np.ones((2, 4, 6), np.float32), ctx=CPU)
    out, _ = cell.unroll(4, x, merge_outputs=True)
    zero = out.asnumpy() == 0
    assert 0 < zero.mean() < 1
    for t in range(1, 4):
        np.testing.assert_array_equal(zero[:, t], zero[:, 0])
    kept = out.asnumpy()[~zero]
    base_out, _ = base.unroll(4, x, merge_outputs=True)
    np.testing.assert_allclose(kept, 2 * base_out.asnumpy()[~zero],
                               rtol=1e-6)
    cell.reset()
    out2, _ = cell.unroll(4, x, merge_outputs=True)
    assert not np.array_equal(out2.asnumpy() == 0, zero)


def test_variational_dropout_rate_zero_is_the_base_cell():
    def make(c, _, rnn):
        return c.rnn.VariationalDropoutCell(rnn.LSTMCell(5, input_size=3))

    jcell, tcell = _build(make)
    jcell.initialize()
    _carry(jcell, tcell)
    x = _rand((2, 4, 3), 3)
    yj, sj = jcell.unroll(4, jmx.nd.array(x), merge_outputs=True)
    yt, st = tcell.unroll(4, tmx.nd.array(x, ctx=CPU), merge_outputs=True)
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), **TOL)
    base_y, _ = tcell._children["base_cell"].unroll(
        4, tmx.nd.array(x, ctx=CPU), merge_outputs=True)
    np.testing.assert_array_equal(yt.asnumpy(), base_y.asnumpy())


def _step_and_grads(jcell, tcell, x, states):
    with jmx.autograd.record():
        oj, nj = jcell(jmx.nd.array(x), [jmx.nd.array(s) for s in states])
        (oj * oj).sum().backward()
    with tmx.autograd.record():
        ot, nt = tcell(tmx.nd.array(x, ctx=CPU),
                       [tmx.nd.array(s, ctx=CPU) for s in states])
        (ot * ot).sum().backward()
    np.testing.assert_allclose(ot.asnumpy(), oj.asnumpy(), **TOL)
    for a, b in zip(nj, nt):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), **TOL)
    _same_grads(jcell, tcell)


def test_lstmp_cell_deferred_input_matches_reference():
    jcell, tcell = _build(lambda c, *_: c.rnn.LSTMPCell(12, 6))
    x = _rand((3, 5), 4)
    jcell.initialize()
    jcell(jmx.nd.array(x), jcell.begin_state(3))  # resolves the width
    tcell(tmx.nd.array(x, ctx=CPU), tcell.begin_state(3))
    assert tuple(tcell.i2h_weight.shape) == (48, 5)
    _carry(jcell, tcell)
    states = [_rand((3, 6), 5), _rand((3, 12), 6)]
    _step_and_grads(jcell, tcell, x, states)
    seq = _rand((3, 4, 5), 7)
    yj, _ = jcell.unroll(4, jmx.nd.array(seq), merge_outputs=True)
    yt, st = tcell.unroll(4, tmx.nd.array(seq, ctx=CPU), merge_outputs=True)
    assert yt.shape == (3, 4, 6) and st[1].shape == (3, 12)
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), **TOL)


CONV_CELLS = [
    ("Conv1DRNNCell", (2, 3, 8)), ("Conv2DRNNCell", (2, 3, 5, 5)),
    ("Conv3DRNNCell", (2, 2, 3, 4, 4)), ("Conv1DLSTMCell", (2, 3, 8)),
    ("Conv2DLSTMCell", (2, 3, 5, 5)), ("Conv3DLSTMCell", (2, 2, 3, 4, 4)),
    ("Conv1DGRUCell", (2, 3, 8)), ("Conv2DGRUCell", (2, 3, 5, 5)),
    ("Conv3DGRUCell", (2, 2, 3, 4, 4)),
]


@pytest.mark.parametrize("cls,x_shape", CONV_CELLS,
                         ids=[c[0] for c in CONV_CELLS])
def test_conv_rnn_cell_step_and_unroll_match_reference(cls, x_shape):
    spatial = x_shape[2:]
    nd = len(spatial)

    def make(c, *_):
        # the input width deferred; i2h 3, h2h 1 (2-D: 3)
        return getattr(c.rnn, cls)((0,) + spatial, 4, 3,
                                   3 if nd == 2 else 1)

    jcell, tcell = _build(make)
    x = _rand(x_shape, 8)
    jcell.initialize()
    jcell(jmx.nd.array(x), jcell.begin_state(x_shape[0]))
    tcell(tmx.nd.array(x, ctx=CPU), tcell.begin_state(x_shape[0]))
    _carry(jcell, tcell)
    states = [_rand(s["shape"], 9 + i)
              for i, s in enumerate(tcell.state_info(x_shape[0]))]
    _step_and_grads(jcell, tcell, x, states)
    seq = _rand((x_shape[0], 3) + x_shape[1:], 12)
    yj, _ = jcell.unroll(3, jmx.nd.array(seq), merge_outputs=True)
    yt, _ = tcell.unroll(3, tmx.nd.array(seq, ctx=CPU), merge_outputs=True)
    assert yt.shape == (x_shape[0], 3, 4) + spatial
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), **TOL)


# ----------------------------------------------------------- deformable
def _deform_ref(arrays, attrs, cot):
    """The reference op's output and its gradients (``jax.vjp``) for the
    cotangent ``cot``."""
    import jax
    import jax.numpy as jnp

    fn = jreg.get_op("_contrib_DeformableConvolution").fn
    out, vjp = jax.vjp(lambda *a: fn(*a, **attrs),
                       *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _deform_port(arrays, attrs, cot):
    fn = treg.get_op("_contrib_DeformableConvolution").fn
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts, **attrs)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


DEFORM = [
    # (id, n, c, h, w, f, kernel, stride, pad, dilate, groups, offset scale)
    ("fractional-over-border", 2, 4, 7, 6, 5, (3, 3), (1, 1), (1, 1),
     (1, 1), 1, 2.5),
    ("two-groups", 2, 6, 8, 8, 4, (3, 3), (1, 1), (1, 1), (1, 1), 2, 1.3),
    ("stride-dilate-pad", 1, 4, 9, 10, 3, (3, 2), (2, 1), (2, 0), (2, 1),
     2, 1.7),
]


@pytest.mark.parametrize("case", DEFORM, ids=[d[0] for d in DEFORM])
@pytest.mark.parametrize("bias", [True, False])
def test_deformable_op_and_gradients_match_reference(case, bias):
    _, n, c, h, w, f, k, s, p, d, g, scale = case
    ho = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    wo = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    arrays = [_rand((n, c, h, w), 20), _rand((n, 2 * g * k[0] * k[1], ho,
                                              wo), 21, -scale, scale),
              _rand((f, c) + k, 22)]
    if bias:
        arrays.append(_rand((f,), 23))
    attrs = dict(kernel=k, num_filter=f, stride=s, pad=p, dilate=d,
                 num_deformable_group=g, no_bias=not bias)
    cot = _rand((n, f, ho, wo), 24)
    want, gwant = _deform_ref(arrays, attrs, cot)
    got, ggot = _deform_port(arrays, attrs, cot)
    np.testing.assert_allclose(got, want, **TOL)
    for name, a, b in zip(("data", "offset", "weight", "bias"), gwant, ggot):
        np.testing.assert_allclose(b, a, err_msg=name, **TOL)


def test_deformable_op_zero_offsets_equal_convolution():
    x, wgt = _rand((2, 3, 8, 8), 30), _rand((4, 3, 3, 3), 31)
    off = np.zeros((2, 18, 8, 8), np.float32)
    fn = treg.get_op("_contrib_DeformableConvolution").fn
    got = fn(torch.from_numpy(x), torch.from_numpy(off),
             torch.from_numpy(wgt), kernel=(3, 3), num_filter=4, pad=(1, 1),
             no_bias=True)
    want = treg.get_op("Convolution").fn(
        torch.from_numpy(x), torch.from_numpy(wgt), None, kernel=(3, 3),
        num_filter=4, pad=(1, 1), no_bias=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    # a half-pixel shift interpolates between the two neighbours
    x1 = np.zeros((1, 1, 4, 4), np.float32)
    x1[0, 0, 1, 1], x1[0, 0, 1, 2] = 1.0, 3.0
    off1 = np.zeros((1, 2, 4, 4), np.float32)
    off1[0, 1] = 0.5
    got1 = fn(torch.from_numpy(x1), torch.from_numpy(off1),
              torch.ones(1, 1, 1, 1), kernel=(1, 1), num_filter=1,
              no_bias=True)
    assert float(got1[0, 0, 1, 1]) == pytest.approx(2.0, abs=1e-6)


def test_deformable_layer_matches_reference():
    def make(c, *_):
        return c.cnn.DeformableConvolution(
            5, kernel_size=3, padding=1, num_deformable_group=2,
            activation="relu", offset_weight_initializer="normal")

    jlayer, tlayer = _build(make)
    x = _rand((2, 4, 6, 6), 40)
    jlayer.initialize(jmx.init.Normal(0.5))
    jlayer(jmx.nd.array(x))
    tlayer.initialize()
    tlayer(tmx.nd.array(x, ctx=CPU))
    _carry(jlayer, tlayer)
    assert np.abs(tlayer.offset_weight.detach().numpy()).max() > 0
    with jmx.autograd.record():
        yj = jlayer(jmx.nd.array(x))
        (yj * yj).sum().backward()
    with tmx.autograd.record():
        yt = tlayer(tmx.nd.array(x, ctx=CPU))
        (yt * yt).sum().backward()
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), **TOL)
    _same_grads(jlayer, tlayer)
    # zero offsets: the plain convolution of the layer's weights
    with context.device_scope("cpu"):
        zero = tcontrib.cnn.DeformableConvolution(6, in_channels=4)
    zero.initialize()
    xt = tmx.nd.array(x, ctx=CPU)
    want = tmx.nd.Convolution(xt, zero.params[zero.prefix + "weight"].data(),
                              zero.params[zero.prefix + "bias"].data(),
                              kernel=(3, 3), pad=(1, 1), num_filter=6)
    np.testing.assert_allclose(zero(xt).asnumpy(), want.asnumpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("length,interval,rollover",
                         [(10, 3, True), (10, 3, False), (7, 7, True),
                          (5, 8, False)])
def test_interval_sampler_matches_reference(length, interval, rollover):
    j = jcontrib.data.IntervalSampler(length, interval, rollover)
    t = tcontrib.data.IntervalSampler(length, interval, rollover)
    assert list(t) == list(j) and len(t) == len(j)
