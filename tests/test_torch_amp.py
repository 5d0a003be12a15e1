"""The port's ``contrib.amp`` against the JAX package's, on the CPU: every
case of ``tests/test_amp.py`` on the port, then the policy through each
dispatch point (``invoke``, Gluon's ``F``, the ``Executor``), a policy
turned on after a net already ran, two steps of a small Gluon net under
``amp.init()`` held against the reference, ``convert_symbol``'s graph
node for node, and ``Trainer.step``'s overflow rule.

Tolerances: the Gluon steps' logits within 1 bfloat16 ULP of their
largest magnitude (2^(e - 7) for a largest magnitude in [2^e, 2^(e+1)))
and their losses within twice the logits' largest difference (plus 1e-6
of the loss for float32 rounding), both packages computing the
convolution and the dense layer in bfloat16 from the same weights; the
rest is exact.
"""
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.contrib import amp as jamp
from incubator_mxnet_tpu.gluon.block import _BlockScope as _JScope

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, context, convert, gluon, nd
from incubator_mxnet_tpu_torch.contrib import amp
from incubator_mxnet_tpu_torch.gluon.block import _BlockScope as _TScope

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.disable()
    jamp.disable()


# ---------------------------------------------------------------------------
# the reference's tests/test_amp.py, on the port
# ---------------------------------------------------------------------------


def test_amp_init_casts_matmul_to_bf16():
    amp.init()
    out = nd.dot(nd.ones((4, 8), ctx=CPU), nd.ones((8, 4), ctx=CPU))
    assert str(out.dtype) == "bfloat16"
    s = nd.softmax(out.astype("float32"), axis=-1)
    assert str(s.dtype) == "float32"


def test_amp_fp32_ops_upcast():
    amp.init()
    x = nd.ones((2, 3), ctx=CPU).astype("bfloat16")
    assert str(nd.exp(x).dtype) == "float32"


def test_amp_integer_inputs_untouched():
    amp.init()
    w = nd.ones((10, 4), ctx=CPU)
    idx = nd.array(np.array([1, 2, 3], np.float32), ctx=CPU)
    out = nd.Embedding(idx, w, input_dim=10, output_dim=4)
    assert out.shape == (3, 4)


def test_loss_scaler_dynamics():
    ls = amp.LossScaler(init_scale=16.0, scale_factor=2.0, scale_window=2)
    ls.update_scale(overflow=True)
    assert ls.loss_scale == 8.0
    ls.update_scale(False)
    ls.update_scale(False)
    assert ls.loss_scale == 16.0


def test_all_finite_op():
    assert bool(nd.all_finite(nd.ones((3, 3), ctx=CPU)).asnumpy().item())
    bad = nd.array(np.array([1.0, np.inf], np.float32), ctx=CPU)
    assert not bool(nd.all_finite(bad).asnumpy().item())


def test_convert_symbol_inserts_casts():
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=8, name="fc")
    sm = mx.sym.softmax(fc, name="sm")
    conv = amp.convert_symbol(sm, target_dtype="bfloat16")
    assert "amp_cast" in conv.tojson()
    exe = conv.bind(CPU, {"data": nd.ones((2, 4), ctx=CPU),
                          "fc_weight": nd.ones((8, 4), ctx=CPU),
                          "fc_bias": nd.zeros((8,), ctx=CPU)})
    out = exe.forward()[0]
    assert str(out.dtype) == "float32"
    np.testing.assert_allclose(out.asnumpy().sum(), 2.0, rtol=1e-2)


def test_convert_model_roundtrip():
    fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                               name="fc")
    arg = {"fc_weight": nd.ones((4, 3), ctx=CPU),
           "fc_bias": nd.zeros((4,), ctx=CPU)}
    new_sym, new_arg, _ = amp.convert_model(fc, arg, {},
                                            target_dtype="bfloat16")
    assert set(new_arg) == set(arg)
    exe = new_sym.bind(CPU, {"data": nd.ones((2, 3), ctx=CPU), **new_arg})
    assert exe.forward()[0].shape == (2, 4)


def _dense(units, **kw):
    with context.device_scope("cpu"):
        return gluon.nn.Dense(units, **kw)


def test_fp16_scaled_gradients_divided_back():
    amp.init(target_dtype="float16")
    net = _dense(1, use_bias=False, in_units=2)
    net.initialize(init=mx.init.Constant(1.0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    amp.init_trainer(trainer)
    trainer._amp_loss_scaler.loss_scale = 4.0
    w0 = net.weight.detach().clone()
    x = nd.ones((1, 2), ctx=CPU)
    with autograd.record():
        y = net(x).sum()
        with amp.scale_loss(y, trainer) as scaled:
            pass
        scaled.backward()
    trainer.step(1)
    np.testing.assert_allclose((w0 - net.weight.detach()).numpy(), 1.0,
                               rtol=1e-2)


def test_scale_loss_and_trainer():
    amp.init(target_dtype="float16")
    net = _dense(2, in_units=4)
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    amp.init_trainer(trainer)
    with autograd.record():
        loss = net(nd.ones((3, 4), ctx=CPU)).sum()
        with amp.scale_loss(loss, trainer) as scaled:
            pass
    assert scaled.asnumpy().item() == loss.asnumpy().item() * \
        trainer._amp_loss_scaler.loss_scale


def test_loss_scaler_growth_cap():
    s = amp.LossScaler(init_scale=2.**23, scale_window=1)
    s.update_scale(False)
    assert s.loss_scale == 2.**24
    s.update_scale(False)
    assert s.loss_scale == 2.**24


def test_scale_window_step_not_halved():
    """The update of the step that doubles the scale divides by the scale
    the loss was multiplied by."""
    def run(scale_window):
        net = _dense(1, use_bias=False, in_units=2)
        net.initialize(init=mx.init.One())
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        scaler = amp.LossScaler(init_scale=4.0, scale_window=scale_window)
        trainer._amp_loss_scaler = scaler
        x = nd.array(np.ones((1, 2), np.float32), ctx=CPU)
        with autograd.record():
            loss = net(x).sum() * scaler.loss_scale
        loss.backward()
        trainer.step(1)
        return net.weight.detach().numpy()

    np.testing.assert_allclose(run(1), run(1000), rtol=1e-6)


# ---------------------------------------------------------------------------
# the policy at every dispatch point
# ---------------------------------------------------------------------------


def test_policy_reaches_invoke_f_and_the_executor():
    """``mx.nd`` (``invoke``), Gluon's ``F`` and the ``Executor`` cast
    alike: the dense product in bfloat16, softmax in float32, an
    unlisted op (relu) in what it is given."""
    amp.init()
    x = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
    w = np.random.RandomState(1).uniform(-1, 1, (5, 4)).astype(np.float32)
    fc = nd.FullyConnected(nd.array(x, ctx=CPU), nd.array(w, ctx=CPU),
                           num_hidden=5, no_bias=True)
    assert str(fc.dtype) == "bfloat16"
    assert str(nd.relu(fc).dtype) == "bfloat16"
    assert str(nd.softmax(fc).dtype) == "float32"
    t = gluon.block.F.FullyConnected(torch.tensor(x), torch.tensor(w),
                                     num_hidden=5, no_bias=True)
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, fc._data)
    sym = mx.sym.softmax(mx.sym.FullyConnected(
        mx.sym.var("x"), num_hidden=5, no_bias=True, name="fc"))
    exe = sym.bind(CPU, {"x": nd.array(x, ctx=CPU),
                         "fc_weight": nd.array(w, ctx=CPU)})
    out = exe.forward()[0]
    assert str(out.dtype) == "float32"
    assert torch.equal(out._data, nd.softmax(fc)._data)
    amp.disable()
    assert gluon.block.F.FullyConnected(torch.tensor(x), torch.tensor(w),
                                        num_hidden=5,
                                        no_bias=True).dtype == torch.float32


def test_policy_turned_on_after_a_net_ran():
    """``F`` decides the cast at each call: a net that ran in float32
    before ``amp.init()`` runs its convolution and dense layer in
    bfloat16 after it, its BatchNorm in float32, and its parameters stay
    float32 with float32 gradients."""
    with context.device_scope("cpu"):
        conv = gluon.nn.Conv2D(4, 3, in_channels=3)
        bn = gluon.nn.BatchNorm(in_channels=4)
        dense = gluon.nn.Dense(3, in_units=4 * 6 * 6)
    for blk in (conv, bn, dense):
        blk.initialize()
    x = nd.array(np.random.RandomState(0).uniform(-1, 1, (2, 3, 8, 8))
                 .astype(np.float32), ctx=CPU)
    assert str(dense(bn(conv(x))).dtype) == "float32"
    amp.init()
    with autograd.record():
        c = conv(x)
        b = bn(c)
        out = dense(b)
        out.astype("float32").sum().backward()
    assert (str(c.dtype), str(b.dtype), str(out.dtype)) == (
        "bfloat16", "float32", "bfloat16")
    for p in list(conv.collect_params().values()) \
            + list(dense.collect_params().values()):
        assert str(p.data().dtype) == "float32"
        assert str(p.grad().dtype) == "float32"
        assert float(p.grad().abs().sum().asscalar()) > 0


def _small_net(m):
    net = m.gluon.nn.HybridSequential()
    net.add(m.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3),
            m.gluon.nn.BatchNorm(in_channels=8),
            m.gluon.nn.Activation("relu"), m.gluon.nn.MaxPool2D(),
            m.gluon.nn.Dense(10, in_units=8 * 16 * 16))
    return net


def _two_steps(m, amp_mod, net, x, y, ctx):
    amp_mod.init()
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.01, "momentum": 0.9})
    amp_mod.init_trainer(trainer)
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = m.nd.array(x, **ctx), m.nd.array(y, **ctx)
    steps = []
    for _ in range(2):
        with m.autograd.record():
            out = net(xs)
            loss = loss_fn(out, ys)
            with amp_mod.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        trainer.step(x.shape[0])
        steps.append((str(out.dtype), out.astype("float32").asnumpy(),
                      str(loss.dtype), loss.asnumpy()))
    return steps


def test_gluon_steps_under_amp_match_reference():
    """Two sgd steps (momentum 0.9, lr 0.01) of Conv2D-BatchNorm-ReLU-
    MaxPool2D-Dense at 32 px, batch 4, under ``amp.init()`` in both
    packages from the same weights: logits bfloat16 and losses float32
    in both, the logits within 1 bfloat16 ULP of their largest
    magnitude, the losses within twice the logits' difference."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    jnet = _small_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    with context.device_scope("cpu"):
        tnet = _small_net(mx)
    convert.params_from_gluon(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    want = _two_steps(jmx, jamp, jnet, x, y, {})
    got = _two_steps(mx, amp, tnet, x, y, {"ctx": CPU})
    for (jd, jo, jld, jl), (td, to, tld, tl) in zip(want, got):
        assert (td, tld) == (jd, jld) == ("bfloat16", "float32")
        ulp = 2.0 ** (np.floor(np.log2(np.abs(jo).max())) - 7)
        dz = np.abs(to - jo).max()
        assert dz <= ulp
        # a sample's loss moves by at most 2x its largest logit change
        # (the L1 norm of softmax - onehot is at most 2), plus f32 rounding
        assert np.abs(tl - jl).max() <= 2 * dz + 1e-6 * np.abs(jl).max()


# ---------------------------------------------------------------------------
# the graph rewrite and the trainer's overflow rule
# ---------------------------------------------------------------------------

#: amp_cast nodes in the converted resnet50_v1(ghost_bn=16) graph: two on
#: each of the 53 convolutions (data, weight) and three on the dense head
RESNET50_CASTS = 53 * 2 + 3


def _resnet50_symbol(m, scope):
    scope._state.counter = {}
    with context.device_scope("cpu"):
        net = m.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                   ghost_bn=16)
    if m is jmx:  # its stem convolution defers its input width
        net.initialize(jmx.init.Zero())
        net.shape_init((1, 3, 32, 32))
    with m.name.NameManager():
        return net(m.sym.var("data"))


def test_convert_symbol_matches_reference_node_for_node():
    """``convert_symbol`` on the exported ``resnet50_v1(ghost_bn=16)``
    graph (chip_smoke phase 3k's) and on a graph of the conditional
    (softrelu, elu) and float32 ops: the port's graph equals the
    reference's node for node, with the same ``amp_cast`` count."""
    def small(m):
        with m.name.NameManager():
            x = m.sym.var("x")
            h = m.sym.Activation(m.sym.FullyConnected(x, num_hidden=4),
                                 act_type="softrelu")
            h = m.sym.LeakyReLU(m.sym.Activation(h, act_type="relu"),
                                act_type="elu")
            h = m.sym.LayerNorm(m.sym.Deconvolution(
                m.sym.reshape(h, shape=(0, 1, 2, 2)), kernel=(2, 2),
                num_filter=3), axis=1)
            return m.sym.softmax(m.sym.exp(h))

    for build in (lambda m, s: _resnet50_symbol(m, s),
                  lambda m, s: small(m)):
        want = jamp.convert_symbol(build(jmx, _JScope))
        got = amp.convert_symbol(build(mx, _TScope))
        jg, tg = json.loads(want.tojson()), json.loads(got.tojson())
        assert len(tg["nodes"]) == len(jg["nodes"])
        for i, (a, b) in enumerate(zip(jg["nodes"], tg["nodes"])):
            assert b == a, "node %d differs" % i
        assert tg["heads"] == jg["heads"]
    # FullyConnected 3, softrelu 1, elu 2 (data and the gamma variable
    # the op composes), Deconvolution 3, LayerNorm 3, exp 1, softmax 1
    casts = sum(n["op"] == "amp_cast" for n in tg["nodes"])
    assert casts == sum(n["op"] == "amp_cast" for n in jg["nodes"]) == 14
    rn = json.loads(amp.convert_symbol(_resnet50_symbol(mx, _TScope))
                    .tojson())
    assert sum(n["op"] == "amp_cast" for n in rn["nodes"]) \
        == RESNET50_CASTS


def test_trainer_skips_update_and_halves_scale_on_overflow():
    """float16 at its 2^16 scale: a planted inf gradient skips the update
    (parameters bit-equal) and halves the scale; a finite one updates."""
    amp.init(target_dtype="float16")
    net = _dense(2, in_units=3)
    net.initialize(init=mx.init.Constant(0.5))
    trainer = amp.init_trainer(gluon.Trainer(net.collect_params(), "sgd",
                                             {"learning_rate": 0.1}))
    assert trainer._amp_loss_scaler.loss_scale == 2.**16
    x = nd.ones((1, 3), ctx=CPU)
    with autograd.record():
        loss = net(x).astype("float32").sum()
        with amp.scale_loss(loss, trainer) as scaled:
            pass
        scaled.backward()
    before = {k: p.data().asnumpy().copy()
              for k, p in net.collect_params().items()}
    net.collect_params()[net.prefix + "weight"].grad()[0, 0] = np.inf
    trainer.step(1)
    for k, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), before[k])
    assert trainer._amp_loss_scaler.loss_scale == 2.**15
    with autograd.record():
        loss = net(x).astype("float32").sum()
        with amp.scale_loss(loss, trainer) as scaled:
            pass
        scaled.backward()
    trainer.step(1)
    assert not np.array_equal(net.weight.detach().numpy(),
                              before[net.prefix + "weight"])
    assert trainer._amp_loss_scaler.loss_scale == 2.**15


def test_exports_the_reference_names():
    """``contrib.amp`` has every public name of the reference's, and its
    op lists are the reference's."""
    public = [n for n in dir(jamp) if not n.startswith("_")]
    missing = [n for n in public if not hasattr(amp, n)]
    assert not missing, missing
    assert amp.list_lp16_ops() == jamp.list_lp16_ops()
    assert amp.list_fp32_ops() == jamp.list_fp32_ops()
    for name in ("FP16_FUNCS", "FP32_FUNCS", "WIDEST_TYPE_CASTS",
                 "CONDITIONAL_FP32_FUNCS", "LOSS_OUTPUT_FUNCS"):
        assert getattr(amp.lists.symbol_bf16, name) \
            == getattr(jamp.lists.symbol_bf16, name), name
