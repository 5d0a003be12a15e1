"""``HybridBlock.export``, ``SymbolBlock`` and the ghost-BN registry ops
of the port against the JAX package's, on the CPU.

- The traced graph: after ``shape_init`` at the same size on both sides,
  a net called on ``sym.var("data")`` gives the reference's graph node
  for node (op, name, attributes, inputs; the JSON), with the same
  ``list_arguments``, ``list_auxiliary_states`` and ``list_outputs``:
  the ghost-BN ResNets (v1-18 at group 8, v1-50 at group 16, each with
  and without the space-to-depth stem), the stock ResNet-18 v1 and v2,
  and one net of each other family (MobileNet v1: the reference cannot
  trace v2, whose ReLU6 passes ``clip`` its bounds by position, which
  ``mx.sym`` refuses in both packages).  A trace, no compute.
- Files cross both ways: the reference's ``export`` runs in the port's
  ``load_checkpoint`` + ``bind`` (inference) and ``SymbolBlock.imports``,
  the port's ``export`` in the reference's ``load_checkpoint`` +
  ``bind``, within 1e-4 of the exporting net's ``net(x)`` (the limit of
  the reference's own deploy test, ``tests/test_fused_bn.py``).
- The six ghost-BN ops in training through the ``Executor`` against the
  reference's ``Executor`` (its Pallas kernels in interpret mode), on a
  small hand-built stack that has every form: ``GhostBNReLU``,
  ``GhostBN``, ``GhostBNAddReLUDual`` without and with donation,
  ``GhostBNAddReLU`` and the two stats-free forms; outputs within 1e-5,
  every argument gradient within 1e-4 and the running stats after the
  step within 1e-6 (the limits of ``test_torch_fused_bn.py``).  The whole
  ResNet-18's gradients are not compared: they are ill-conditioned in f32
  at test sizes (ROADMAP Queue C); its forward and running stats are.
- ``SymbolBlock``: its parameters carry the graph's names, gradients
  under ``autograd.record()`` reach them (equal to the Executor's), and
  no running stat moves.
- The ghost-BN layers with ``track_stats=False``: no running stats, the
  same outputs as the reference's in training and inference (1e-5), the
  same traced graph.

Reference weights come from its Xavier initializer (zeros where only the
graph is compared, which is quicker); running stats are drawn in numpy
so that inference depends on them.
"""
import json
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.block import _BlockScope as _JScope
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, initializer
from incubator_mxnet_tpu_torch.gluon.block import _BlockScope as _TScope
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

CPU = tmx.cpu()
CLASSES = 10

# (model, keywords, image side)
GRAPHS = [
    ("resnet18_v1", dict(ghost_bn=8), 32),
    ("resnet18_v1", dict(ghost_bn=8, s2d_stem=True), 32),
    ("resnet50_v1", dict(ghost_bn=16), 32),
    ("resnet50_v1", dict(ghost_bn=16, s2d_stem=True), 32),
    ("resnet18_v1", {}, 32),
    ("resnet18_v2", {}, 32),
    ("alexnet", {}, 64),
    ("vgg11_bn", {}, 32),
    ("squeezenet1_1", {}, 64),
    ("densenet121", {}, 32),
    ("mobilenet0_25", {}, 32),
    ("inception_v3", {}, 299),
]


def _fresh_names():
    _JScope._state.counter = {}
    _TScope._state.counter = {}


def _jax_net(name, kw, side, init=None):
    net = jvision.get_model(name, classes=CLASSES, **kw)
    net.initialize(init or jmx.init.Zero())
    net.shape_init((1, 3, side, side))
    return net


def _port_net(name, kw, side):
    with context.device_scope("cpu"):
        net = tvision.get_model(name, classes=CLASSES, **kw)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator().manual_seed(0))
    tmx.gluon.shape_init(net, (1, 3, side, side))
    return net


def _trace(net, mod):
    with mod.name.NameManager():
        return net(mod.sym.var("data"))


@pytest.mark.parametrize("name,kw,side", GRAPHS,
                         ids=["%s%s" % (n, "".join("-%s%s" % kv
                                                   for kv in k.items()))
                              for n, k, _ in GRAPHS])
def test_traced_graph_matches_reference(name, kw, side):
    _fresh_names()
    js = _trace(_jax_net(name, kw, side), jmx)
    ts = _trace(_port_net(name, kw, side), tmx)
    jg, tg = json.loads(js.tojson()), json.loads(ts.tojson())
    assert len(tg["nodes"]) == len(jg["nodes"])
    for i, (a, b) in enumerate(zip(jg["nodes"], tg["nodes"])):
        assert b == a, "node %d differs" % i
    assert tg["heads"] == jg["heads"]
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()


def _random_stats(params, set_data, seed):
    """Running stats drawn in numpy (means about 0, variances 0.5-1.5)."""
    rng = np.random.RandomState(seed)
    for name, p in params.items():
        if name.endswith("running_mean"):
            set_data(p, rng.normal(0, 0.1, p.shape).astype(np.float32))
        elif name.endswith("running_var"):
            set_data(p, rng.uniform(0.5, 1.5, p.shape).astype(np.float32))


def _batch(side, n=4, seed=1):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, 3, side, side)).astype(np.float32)


CROSS = [("resnet18_v1", dict(ghost_bn=8)), ("resnet18_v1", {})]


@pytest.mark.parametrize("name,kw", CROSS, ids=["ghost_bn8", "stock"])
def test_reference_export_runs_in_port(name, kw, tmp_path):
    _fresh_names()
    jmx.random.seed(0)
    net = _jax_net(name, kw, 32, jmx.init.Xavier())
    _random_stats(net.collect_params(),
                  lambda p, v: p.set_data(jmx.nd.array(v)), 2)
    x = _batch(32)
    want = net(jmx.nd.array(x)).asnumpy()
    prefix = str(tmp_path / "ref")
    net.export(prefix)
    sym, args, aux = tmx.model.load_checkpoint(prefix, 0, ctx=CPU)
    binds = dict(args, data=tmx.nd.array(x, ctx=CPU))
    got = sym.bind(CPU, args=binds, aux_states=aux).forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    block = tmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params", ctx=CPU)
    got = block(tmx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,kw", CROSS, ids=["ghost_bn8", "stock"])
def test_port_export_runs_in_reference(name, kw, tmp_path):
    _fresh_names()
    net = _port_net(name, kw, 32)
    _random_stats(net.collect_params(), lambda p, v: p.set_data(v), 3)
    x = _batch(32)
    want = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    prefix = str(tmp_path / "port")
    files = net.export(prefix)
    assert files == (prefix + "-symbol.json", prefix + "-0000.params")
    sym, args, aux = jmx.model.load_checkpoint(prefix, 0)
    binds = dict(args, data=jmx.nd.array(x))
    got = sym.bind(jmx.cpu(), args=binds, aux_states=aux) \
        .forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_exported_ghost_net_steps_as_gluon(tmp_path):
    """The port's exported ghost ResNet-18 through ``simple_bind`` and one
    training forward and backward equals the Gluon net's step on the same
    batch and head gradient bit for bit on the CPU (the same ops in the
    same order): the output, every argument gradient and the running
    stats the step moved; and the reference's Executor agrees on the
    output and the running stats."""
    _fresh_names()
    net = _port_net("resnet18_v1", dict(ghost_bn=8), 32)
    prefix = str(tmp_path / "g")
    net.export(prefix)
    sym, args, aux = tmx.model.load_checkpoint(prefix, 0, ctx=CPU)
    x = _batch(32, n=8)
    head = np.random.RandomState(4).normal(size=(8, CLASSES)) \
        .astype(np.float32)
    exe = sym.simple_bind(CPU, data=x.shape)
    exe.copy_params_from(args, aux)
    exe.forward(is_train=True, data=tmx.nd.array(x, ctx=CPU))
    exe.backward(tmx.nd.array(head, ctx=CPU))
    with tmx.autograd.record():
        y = net(tmx.nd.array(x, ctx=CPU))
    y.backward(tmx.nd.array(head, ctx=CPU))
    assert torch.equal(exe.outputs[0]._data, y._data)
    params = net.collect_params()
    for name in exe.grad_dict:
        if name != "data":
            assert torch.equal(exe.grad_dict[name]._data,
                               params[name].grad()._data), name
    for name in exe.aux_dict:
        assert torch.equal(exe.aux_dict[name]._data,
                           params[name].data()._data), name

    jsym, jargs, jaux = jmx.model.load_checkpoint(prefix, 0)
    jexe = jsym.simple_bind(jmx.cpu(), data=x.shape)
    jexe.copy_params_from(jargs, jaux)
    jout = jexe.forward(is_train=True, data=jmx.nd.array(x))[0].asnumpy()
    np.testing.assert_allclose(exe.outputs[0].asnumpy(), jout, rtol=0,
                               atol=1e-4)
    for name, arr in jexe.aux_dict.items():
        np.testing.assert_allclose(exe.aux_dict[name].asnumpy(),
                                   arr.asnumpy(), rtol=0, atol=1e-5)


def _ghost_stack(S, c, group):
    """Every ghost-BN form on one small graph (``S`` is ``mx.sym``)."""
    def conv(x, name):
        return S.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=c,
                             no_bias=True, name=name)

    kw = dict(eps=1e-5, momentum=0.9, group=group)
    a = S.contrib.GhostBNReLU(conv(S.var("data"), "c0"), name="g0", **kw)[0]
    short = S.contrib.GhostBN(conv(a, "cd"), name="gd", **kw)[0]
    d1 = S.contrib.GhostBNAddReLUDual(conv(a, "c1"), short, name="g1",
                                      donate_residual=1, **kw)
    d2 = S.contrib.GhostBNAddReLUDual(conv(d1[0], "c2"), d1[1], name="g2",
                                      donate_residual=0, **kw)
    e = S.contrib.GhostBNAddReLU(conv(d2[0], "c3"), d2[1], name="g3",
                                 **kw)[0]
    ns = S.contrib.GhostBNReLUNS(e, name="n0", eps=1e-5, group=group)
    return S.contrib.GhostBNNS(ns, name="n1", eps=1e-5, group=group)


@pytest.mark.parametrize("shape,group", [((8, 128, 4, 4), 4),
                                         ((8, 32, 6, 6), 0)],
                         ids=["c128_group4", "c32_batch"])
def test_ghost_ops_train_through_executor(shape, group):
    ts = _ghost_stack(tmx.sym, shape[1], group)
    js = _ghost_stack(jmx.sym, shape[1], group)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    rng = np.random.RandomState(5)
    # neither package infers a ghost op's per-channel inputs (an exported
    # net's variables carry their shapes)
    given = {n: (shape[1],) for n in ts.list_inputs()
             if n.endswith(("gamma", "beta", "moving_mean", "moving_var"))}
    given["data"] = shape
    arg_shapes, _, aux_shapes = ts.infer_shape(**given)
    assert (arg_shapes, aux_shapes) == js.infer_shape(**given)[::2]
    args = {}
    for name, s in zip(ts.list_arguments(), arg_shapes):
        if name.endswith("weight"):
            args[name] = rng.normal(0, 0.1, s)
        elif name.endswith("gamma"):
            args[name] = rng.uniform(0.5, 1.5, s)
        elif name.endswith("beta"):
            args[name] = rng.normal(0, 0.2, s)
        else:
            args[name] = rng.normal(0.5, 2.0, s)
    aux = {name: (rng.uniform(0.5, 1.5, s) if name.endswith("var")
                  else rng.normal(0, 0.1, s))
           for name, s in zip(ts.list_auxiliary_states(), aux_shapes)}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    aux = {k: v.astype(np.float32) for k, v in aux.items()}
    head = rng.normal(size=shape).astype(np.float32)

    texe = ts.simple_bind(CPU, **given)
    texe.copy_params_from({k: tmx.nd.array(v, ctx=CPU)
                           for k, v in args.items()},
                          {k: tmx.nd.array(v, ctx=CPU)
                           for k, v in aux.items()})
    tout = texe.forward(is_train=True)[0].asnumpy()
    texe.backward(tmx.nd.array(head, ctx=CPU))
    jexe = js.simple_bind(jmx.cpu(), **given)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in args.items()},
                          {k: jmx.nd.array(v) for k, v in aux.items()})
    jout = jexe.forward(is_train=True)[0].asnumpy()
    jexe.backward(jmx.nd.array(head))

    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5)
    for name in args:
        np.testing.assert_allclose(texe.grad_dict[name].asnumpy(),
                                   jexe.grad_dict[name].asnumpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    for name in aux:
        moved = texe.aux_dict[name].asnumpy()
        assert not np.array_equal(moved, aux[name]), name
        np.testing.assert_allclose(moved, jexe.aux_dict[name].asnumpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_symbol_block_names_grads_and_no_stat_commit(tmp_path):
    _fresh_names()
    net = _port_net("resnet18_v1", dict(ghost_bn=8), 32)
    prefix = str(tmp_path / "s")
    net.export(prefix)
    block = tmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                          prefix + "-0000.params", ctx=CPU)
    sym = tmx.sym.load(prefix + "-symbol.json")
    names = [n for n in sym.list_arguments() if n != "data"] \
        + sym.list_auxiliary_states()
    assert sorted(block.collect_params().keys()) == sorted(names)
    assert sorted(names) == sorted(net.collect_params().keys())
    aux = set(sym.list_auxiliary_states())
    params = block.collect_params()
    assert all((params[n].grad_req == "null") == (n in aux) for n in names)
    before = {n: params[n].data().asnumpy().copy() for n in aux}

    x = tmx.nd.array(_batch(32, n=8), ctx=CPU)
    with tmx.autograd.record():
        y = block(x)
    y.backward()
    for n in aux:
        np.testing.assert_array_equal(params[n].data().asnumpy(), before[n])
    exe = sym.simple_bind(CPU, data=x.shape)
    exe.copy_params_from(*tmx.model.load_checkpoint(prefix, 0, ctx=CPU)[1:])
    exe.forward(is_train=True, data=x)
    exe.backward()
    assert torch.equal(exe.outputs[0]._data, y._data)
    for n in names:
        if n not in aux:
            g = params[n].grad()._data
            assert g.abs().sum() > 0, n
            assert torch.equal(g, exe.grad_dict[n]._data), n


def test_symbol_block_infers_shapes_from_the_input():
    """A ``SymbolBlock`` over a graph without a parameter file takes its
    shapes from the first input and initializes then."""
    data = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(
        tmx.sym.Activation(tmx.sym.Convolution(
            data, kernel=(3, 3), num_filter=4, name="conv"),
            act_type="relu"), num_hidden=3, name="fc")
    block = tmx.gluon.SymbolBlock(out, data, device=CPU)
    block.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_batch(6, n=2), ctx=CPU)
    y = block(x)
    assert y.shape == (2, 3)
    params = block.collect_params()
    assert params["conv_weight"].shape == (4, 3, 3, 3)
    assert params["fc_weight"].shape == (3, 64)
    want = tmx.sym.Group([out]).bind(CPU, args=dict(
        data=x, **{n: p.data() for n, p in params.items()})).forward()[0]
    assert torch.equal(y._data, want._data)


def test_parameter_var_is_cached_with_shape_and_dtype():
    p = tmx.gluon.Parameter("w", shape=(3, 4))
    v = p.var()
    assert v is p.var()
    assert v.name == "w"
    node = json.loads(v.tojson())["nodes"][0]
    jnode = json.loads(jmx.gluon.Parameter("w", shape=(3, 4)).var()
                       .tojson())["nodes"][0]
    assert node == jnode


def test_export_writes_arg_and_aux_keys(tmp_path):
    _fresh_names()
    net = _port_net("resnet18_v1", dict(ghost_bn=8), 32)
    prefix = str(tmp_path / "k")
    net.export(prefix, epoch=7)
    assert os.path.exists(prefix + "-0007.params")
    saved = tmx.nd.load(prefix + "-0007.params", ctx=CPU)
    aux = {"aux:" + n for n, _ in net.collect_params().items()
           if n.endswith(("running_mean", "running_var"))}
    assert {k for k in saved if k.startswith("aux:")} == aux
    assert len(saved) == len(net.collect_params())


@pytest.mark.parametrize("cls", ["GhostBNReLU", "GhostBN"])
def test_ghost_layer_without_running_stats(cls):
    """``track_stats=False``: no running stats, the ghost groups'
    statistics in every mode (the ``NS`` ops), on tensors and traced,
    as the reference's layer."""
    from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres

    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet \
        as tres

    _fresh_names()
    c = 16
    jl = getattr(jres, cls)(group=4, track_stats=False)
    jl.initialize()
    with context.device_scope("cpu"):
        tl = getattr(tres, cls)(group=4, track_stats=False, in_channels=c)
    rng = np.random.RandomState(6)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    x = rng.normal(0.5, 2.0, (8, c, 5, 5)).astype(np.float32)
    jl.shape_init(x.shape)
    for layer, arr in ((jl, jmx.nd.array), (tl, lambda v: v)):
        params = layer.collect_params()
        assert sorted(params.keys()) == [layer.prefix + "beta",
                                         layer.prefix + "gamma"]
        params[layer.prefix + "gamma"].set_data(arr(gamma))
        params[layer.prefix + "beta"].set_data(arr(beta))
    for train in (True, False):
        with jmx.autograd.record(train_mode=train):
            want = jl(jmx.nd.array(x)).asnumpy()
        with tmx.autograd.record(train_mode=train):
            got = tl(tmx.nd.array(x, ctx=CPU)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    js, ts = _trace(jl, jmx), _trace(tl, tmx)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    assert ts.list_auxiliary_states() == []
