"""The port's ``Parameter``/``Block``/``HybridBlock`` against the JAX
package's.

- ``collect_params()``: names, shapes and ``grad_req`` equal the
  reference's for ``resnet18_v1``, ``mobilenet1_0`` and
  ``resnet50_v1(s2d_stem=True)`` (each package's global name counter
  reset before its net is built, so the names are equal exactly), in
  the reference's order (BN: gamma, beta, running_mean, running_var);
  ``_collect_params_with_prefix()`` (the ``.params`` files' structural
  names) equal exactly.
- ``.params`` files from ``save_parameters`` load across the packages
  both ways, bit for bit.
- A user ``HybridBlock`` with ``hybrid_forward`` and ``params.get``
  gives the reference's outputs and gradients (f32, 1e-5).
- One tensor per parameter: ``Parameter.data()`` is the module's tensor
  (``named_parameters()``/``named_buffers()``), before and after
  ``trainer.step``, and the next forward sees the update.
- Train mode follows ``autograd`` on the NDArray path: BN uses batch
  statistics and moves its running stats inside ``record()``, the
  running stats outside, as the reference (f32, 1e-5).
- ``ParameterDict`` files cross both ways bit for bit; ``Constant``.
"""
import copy

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import block as jblock
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.gluon import block as tblock
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

CPU = tmx.cpu()
SHAPE = (1, 3, 32, 32)


def _fresh_names():
    jblock._BlockScope._state.counter = {}
    tblock._BlockScope._state.counter = {}


def _pair(name, **kw):
    """(reference net, port net) of the zoo, initialized, shapes
    resolved at 32 px; the port's weights copied from the reference's by
    name."""
    _fresh_names()
    jmx.random.seed(0)
    jnet = getattr(jvision, name)(classes=10, **kw)
    jnet.initialize(init=jmx.init.Xavier())
    jnet.shape_init(SHAPE)
    _fresh_names()
    tnet = getattr(tvision, name)(classes=10, device="cpu", **kw)
    tnet.initialize(init=tmx.init.Xavier())
    tnet.shape_init(SHAPE)
    convert.params_from_gluon(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    return jnet, tnet


@pytest.mark.parametrize("name,kw", [("resnet18_v1", {}),
                                     ("mobilenet1_0", {}),
                                     ("resnet50_v1", {"s2d_stem": True})],
                         ids=["resnet18_v1", "mobilenet1_0", "resnet50_s2d"])
def test_collect_params_match_reference(name, kw):
    jnet, tnet = _pair(name, **kw)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert [(k, tuple(p.shape), p.grad_req) for k, p in jp.items()] == \
        [(k, tuple(p.shape), p.grad_req) for k, p in tp.items()]
    assert list(jnet._collect_params_with_prefix()) == \
        list(tnet._collect_params_with_prefix())
    # the torch registration lists the same tensors, in the same order
    tensors = dict(tnet.named_parameters())
    tensors.update(tnet.named_buffers())
    for sname, p in tnet._collect_params_with_prefix().items():
        assert tensors[sname] is p.data()._data


def test_params_files_cross_both_ways(tmp_path):
    jnet, tnet = _pair("resnet18_v1")
    with torch.no_grad():
        for _, t in tnet.named_parameters():
            t.mul_(1.5)
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet.save_parameters(str(tmp_path / "t.params"))
    jvals = [p.data().asnumpy() for p in jnet.collect_params().values()]
    tvals = [p.data().asnumpy() for p in tnet.collect_params().values()]
    tnet.load_parameters(str(tmp_path / "j.params"))
    jnet.load_parameters(str(tmp_path / "t.params"))
    names = list(tnet.collect_params())
    for k, want, p in zip(names, jvals, tnet.collect_params().values()):
        np.testing.assert_array_equal(p.data().asnumpy(), want, err_msg=k)
    for k, want, p in zip(names, tvals, jnet.collect_params().values()):
        np.testing.assert_array_equal(p.data().asnumpy(), want, err_msg=k)


def _user_block(pkg):
    class Scaled(pkg.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.w = self.params.get("w", shape=(5, 4))
                self.b = self.params.get("b", shape=(5,), init="zeros")
                self.dense = pkg.gluon.nn.Dense(3, in_units=5)

        def hybrid_forward(self, F, x, w, b):  # noqa: N803
            h = F.relu(F.FullyConnected(x, w, b, num_hidden=5))
            return self.dense(h) * 2 + F.sum(h, axis=1, keepdims=True)

    return Scaled


def test_user_hybrid_block_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    _fresh_names()
    jnet = _user_block(jmx)()
    jnet.initialize(init=jmx.init.Xavier())
    _fresh_names()
    with context.device_scope("cpu"):
        tnet = _user_block(tmx)()
    tnet.initialize(init=tmx.init.Xavier())
    assert list(jnet.collect_params()) == list(tnet.collect_params()) == \
        ["scaled0_w", "scaled0_b", "scaled0_dense0_weight",
         "scaled0_dense0_bias"]
    arrays = {k: rng.normal(size=p.shape).astype(np.float32)
              for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(arrays[k]))
    convert.params_from_gluon(tnet, arrays)
    outs = {}
    for pkg, net, nd_kw in ((jmx, jnet, {}), (tmx, tnet, {"ctx": CPU})):
        xx = pkg.nd.array(x, **nd_kw)
        with pkg.autograd.record():
            out = net(xx)
            loss = (out * out).sum()
        loss.backward()
        outs[pkg] = (out.asnumpy(), [p.grad().asnumpy() for p in
                                     net.collect_params().values()])
    np.testing.assert_allclose(outs[tmx][0], outs[jmx][0], rtol=1e-5,
                               atol=1e-5)
    for tg, jg in zip(outs[tmx][1], outs[jmx][1]):
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


def test_one_tensor_per_parameter_through_trainer_step():
    _fresh_names()
    with context.device_scope("cpu"):
        net = tvision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize(init=tmx.init.Xavier())
    net.shape_init(SHAPE)
    tensors = dict(net.named_parameters())
    tensors.update(net.named_buffers())
    structural = net._collect_params_with_prefix()
    assert set(structural) == set(tensors)
    before = {k: t.detach().clone() for k, t in tensors.items()}
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    rng = np.random.RandomState(1)
    x = tmx.nd.array(rng.rand(4, 3, 32, 32).astype(np.float32), ctx=CPU)
    y = tmx.nd.array(np.array([1, 2, 3, 4], np.float32), ctx=CPU)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(x), y).mean()
    loss.backward()
    for name, p in structural.items():
        if p.grad_req != "null":
            assert p.grad().shape == p.shape, name
    trainer.step(4)
    for name, p in structural.items():
        t = p.data()._data
        assert t is tensors[name] and t.data_ptr() == \
            tensors[name].data_ptr(), name
        if p.grad_req != "null":
            assert not torch.equal(t, before[name]), name
    # the next forward sees the update: the module computes with the
    # updated tensors, not the ones before the step
    stale = copy.deepcopy(net)
    net.eval()
    stale.eval()
    with torch.no_grad():
        for k, t in stale.named_parameters():
            t.copy_(before[k])
        xt = x._data
        assert not torch.equal(stale(xt), net(xt))
        for k, t in stale.named_parameters():
            t.copy_(tensors[k])
        assert torch.equal(stale(xt), net(xt))


def test_batch_norm_mode_follows_autograd():
    rng = np.random.RandomState(2)
    x = (rng.normal(size=(4, 3, 5, 5)) * 2 + 1).astype(np.float32)
    res = {}
    for pkg, nd_kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        if pkg is tmx:
            with context.device_scope("cpu"):
                bn = pkg.gluon.nn.BatchNorm(in_channels=3)
        else:
            bn = pkg.gluon.nn.BatchNorm(in_channels=3)
        bn.initialize()
        xx = pkg.nd.array(x, **nd_kw)
        out_pred = bn(xx).asnumpy()                 # running stats
        with pkg.autograd.record():
            out_train = bn(xx)                      # batch stats
        rm = bn.collect_params()[bn.prefix + "running_mean"].data()
        out_after = bn(xx).asnumpy()                # moved stats
        with pkg.autograd.train_mode():
            out_tm = bn(xx).asnumpy()               # batch stats again
        res[pkg] = (out_pred, out_train.asnumpy(), rm.asnumpy(), out_after,
                    out_tm)
    for t, j in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    out_pred, out_train, rm, _, _ = res[tmx]
    np.testing.assert_allclose(out_pred, x / np.sqrt(1 + 1e-5), rtol=1e-5)
    assert abs(out_train.mean()) < 1e-5 and np.all(rm != 0)


def test_block_api_surface():
    with context.device_scope("cpu"):
        net = tmx.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(tmx.gluon.nn.Dense(4, in_units=3),
                    tmx.gluon.nn.Dense(2))
    assert list(net.collect_params("net_dense1_.*")) == [
        "net_dense1_weight", "net_dense1_bias"]
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        net[1].params.get("weight").data()
    net.initialize(ctx=CPU)
    net.collect_params().setattr("grad_req", "null")
    net.hybridize()
    out = net(tmx.nd.ones((5, 3), ctx=CPU))
    assert isinstance(out, tmx.NDArray) and out.shape == (5, 2)
    assert not any(t.requires_grad for t in net.parameters())
    net.cast("float64")
    assert all(t.dtype == torch.float64 for t in net.parameters())


def test_parameter_dict_files_and_constants(tmp_path):
    """``ParameterDict.save``/``load`` (full names, ``strip_prefix``/
    ``restore_prefix``) cross the packages both ways bit for bit; a
    ``Constant`` holds its value without gradient."""
    rng = np.random.RandomState(4)
    values = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    dicts = {}
    for pkg in (jmx, tmx):
        d = pkg.gluon.ParameterDict("net_")
        for k, v in values.items():
            d.get(k, shape=v.shape)
        kw = {"ctx": CPU} if pkg is tmx else {}
        d.initialize(**kw)
        for k, v in values.items():
            d["net_" + k].set_data(pkg.nd.array(v * (2 if pkg is tmx else 1),
                                                **kw))
        dicts[pkg] = d
    dicts[jmx].save(str(tmp_path / "j.params"), strip_prefix="net_")
    dicts[tmx].save(str(tmp_path / "t.params"), strip_prefix="net_")
    dicts[tmx].load(str(tmp_path / "j.params"), restore_prefix="net_")
    dicts[jmx].load(str(tmp_path / "t.params"), restore_prefix="net_")
    for k, v in values.items():
        np.testing.assert_array_equal(dicts[tmx]["net_" + k].data().asnumpy(),
                                      v)
        np.testing.assert_array_equal(dicts[jmx]["net_" + k].data().asnumpy(),
                                      2 * v)
    c = dicts[tmx].get_constant("c", np.arange(4, dtype=np.float32))
    c.initialize(ctx=CPU)
    assert c.grad_req == "null" and dicts[tmx].get_constant("c") is c
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(4))
    with pytest.raises(RuntimeError):
        c.grad()
