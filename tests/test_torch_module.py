"""``mx.mod.Module``, ``mx.model`` checkpoints, ``callback``,
``monitor`` and ``io.MNISTIter`` against the JAX package's.

- ``MNISTIter`` over idx files the test writes (plain and gzip): the
  same batches, pads and descriptors as the reference, flat and not,
  shuffled (the reference's numpy draws, the global seed set the same
  before each) and split by ``part_index``/``num_parts``.
- ``model.save_checkpoint`` of either package loads in the other
  (``-symbol.json`` byte for byte, ``.params`` by name), through
  ``Module.load`` and ``load_checkpoint``, and both give the same
  forward outputs (1e-5 relative).
- The Module API on the CPU: ``bind``/``init_params`` (the reference's
  name rules: biases 0, gamma and running variance 1), ``get_params``/
  ``set_params``, ``save_params``/``load_params``, the optimizer states
  crossing the packages (the next step then equal, 1e-5), ``predict``
  (merged, padding cut), ``score``, ``reshape``, ``fixed_param_names``,
  ``inputs_need_grad``, the monitor and the callbacks of ``fit``; a
  list of several contexts is refused (ROADMAP A8).
"""
import gzip
import logging
import os
import struct

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _write_idx(path, arr):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", (0x08 << 8) | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture
def idx_files(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (23, 28, 28))
    lab = rng.randint(0, 10, 23)
    paths = []
    for suffix in ("", ".gz"):
        i = str(tmp_path / ("images-idx3-ubyte" + suffix))
        l_ = str(tmp_path / ("labels-idx1-ubyte" + suffix))
        _write_idx(i, img)
        _write_idx(l_, lab)
        paths.append((i, l_))
    return paths


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("kw", [
    dict(flat=True, shuffle=False),
    dict(flat=False, shuffle=True),
    dict(flat=True, shuffle=True, part_index=1, num_parts=3),
])
def test_mnist_iter_matches_reference(idx_files, gz, kw):
    image, label = idx_files[gz]
    np.random.seed(5)
    jit = jmx.io.MNISTIter(image=image, label=label, batch_size=4, **kw)
    np.random.seed(5)
    tit = tmx.io.MNISTIter(image=image, label=label, batch_size=4, ctx=CPU,
                           **kw)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _ in range(2):  # two epochs: the second shuffles again
        jit.reset()
        tit.reset()
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) > 0
        for j, t in zip(jb, tb):
            assert t.pad == j.pad
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())


def _net(S):
    x = S.Convolution(S.var("data"), kernel=(3, 3), num_filter=4,
                      name="conv")
    x = S.BatchNorm(x, fix_gamma=False, name="bn")
    x = S.Activation(x, act_type="tanh", name="act")
    x = S.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool")
    x = S.FullyConnected(S.Flatten(x), num_hidden=3, name="fc")
    return S.SoftmaxOutput(x, name="softmax")


SHAPE = (4, 2, 8, 8)
_RNG = np.random.RandomState(1)
X = _RNG.normal(size=SHAPE).astype(np.float32)
Y = np.array([0, 2, 1, 2], np.float32)


def _module(pkg, bind_kw=None, **kw):
    with pkg.name.NameManager():
        sym = _net(pkg.sym)
    mod = pkg.mod.Module(sym, context=pkg.cpu(), **kw)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (SHAPE[0],))], **(bind_kw or {}))
    return mod


def _batch(pkg, x=X, y=Y):
    ctx = {"ctx": CPU} if pkg is tmx else {}
    return pkg.io.DataBatch([pkg.nd.array(x, **ctx)],
                            [pkg.nd.array(y, **ctx)])


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _random_params(mod):
    rng = np.random.RandomState(2)
    arg, aux = mod.get_params()
    return ({k: rng.normal(size=v.shape).astype(np.float32) * 0.3
             for k, v in arg.items()},
            {k: (np.abs(rng.normal(size=v.shape)) + 0.5).astype(np.float32)
             for k, v in aux.items()})


def _pair(bind_kw=None, **kw):
    """A JAX and a port Module of ``_net`` on the CPU with the same
    parameters (random, by name)."""
    jmod, tmod = _module(jmx, bind_kw, **kw), _module(tmx, bind_kw, **kw)
    jmod.init_params()
    arg, aux = _random_params(jmod)
    jmod.set_params({k: jmx.nd.array(v) for k, v in arg.items()},
                    {k: jmx.nd.array(v) for k, v in aux.items()})
    tmod.init_params(arg_params={k: tmx.nd.array(v, ctx=CPU)
                                 for k, v in arg.items()},
                     aux_params={k: tmx.nd.array(v, ctx=CPU)
                                 for k, v in aux.items()})
    return jmod, tmod


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    jmod, tmod = _pair()
    prefix = str(tmp_path / "net")
    (jmod if writer == "jax" else tmod).save_checkpoint(prefix, 3)
    jsym, jarg, jaux = jmx.model.load_checkpoint(prefix, 3)
    tsym, targ, taux = tmx.model.load_checkpoint(prefix, 3, ctx=CPU)
    assert tsym.tojson() == jsym.tojson() == \
        open(prefix + "-symbol.json").read()
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)
    for k in jarg:
        np.testing.assert_array_equal(targ[k].asnumpy(), jarg[k].asnumpy())
    loaded = tmx.mod.Module.load(prefix, 3, context=CPU)
    loaded.bind(data_shapes=[("data", SHAPE)],
                label_shapes=[("softmax_label", (SHAPE[0],))],
                for_training=False)
    loaded.init_params()
    jmod.forward(_batch(jmx), is_train=False)
    loaded.forward(_batch(tmx), is_train=False)
    _close(loaded.get_outputs()[0].asnumpy(),
           jmod.get_outputs()[0].asnumpy())


def test_module_defaults_follow_the_reference():
    """``init_params`` by name rules (Uniform(0.01) weights), data and
    label without gradient, and ``rescale_grad`` 1 / batch."""
    tmod = _module(tmx)
    tmod.init_params()
    arg, aux = _np(tmod.get_params()[0]), _np(tmod.get_params()[1])
    assert np.abs(arg["conv_weight"]).max() <= 0.01
    assert np.abs(arg["conv_weight"]).max() > 0
    for k in ("conv_bias", "bn_beta", "fc_bias"):
        assert not arg[k].any()
    np.testing.assert_array_equal(arg["bn_gamma"], 1)
    np.testing.assert_array_equal(aux["bn_moving_var"], 1)
    assert not aux["bn_moving_mean"].any()
    req = tmod._exec.grad_req
    assert req["data"] == req["softmax_label"] == "null"
    assert req["conv_weight"] == "write"
    tmod.init_optimizer()
    assert tmod._optimizer.rescale_grad == 1.0 / SHAPE[0]


def _step(mod, pkg, x=X, y=Y):
    mod.forward_backward(_batch(pkg, x, y))
    mod.update()


def test_module_steps_and_optimizer_states_cross(tmp_path):
    """Two sgd-momentum steps match the reference (BN running stats
    included); the optimizer states of either package load into the
    other's module and the third step still matches."""
    jmod, tmod = _pair()
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-3})
    jmod.init_optimizer(**opt)
    tmod.init_optimizer(**opt)
    for _ in range(2):
        _step(jmod, jmx)
        _step(tmod, tmx)
    for j, t in zip(jmod.get_params(), tmod.get_params()):
        for k in j:
            _close(t[k].asnumpy(), j[k].asnumpy())
    jpath, tpath = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jmod.save_optimizer_states(jpath)
    tmod.save_optimizer_states(tpath)
    tmod.load_optimizer_states(jpath)
    jmod.load_optimizer_states(tpath)
    _step(jmod, jmx)
    _step(tmod, tmx)
    for k, v in jmod.get_params()[0].items():
        _close(tmod.get_params()[0][k].asnumpy(), v.asnumpy())


def test_params_files_and_set_params(tmp_path):
    jmod, tmod = _pair()
    path = str(tmp_path / "t.params")
    tmod.save_params(path)
    other = _module(tmx)
    other.init_params()
    other.load_params(path)
    for a, b in zip(other.get_params(), tmod.get_params()):
        for k in a:
            np.testing.assert_array_equal(a[k].asnumpy(), b[k].asnumpy())
    jmod.load_params(path)
    for k, v in jmod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      tmod.get_params()[0][k].asnumpy())
    arg, aux = tmod.get_params()
    with pytest.raises(tmx.base.MXNetError, match="missing"):
        other.set_params({}, aux)
    with pytest.raises(tmx.base.MXNetError, match="unknown"):
        other.set_params(dict(arg, extra=arg["fc_bias"]), aux)
    # set_params copies: updating the module leaves the caller's arrays
    before = arg["fc_weight"].asnumpy()
    other.set_params(arg, aux)
    other.init_optimizer(optimizer_params={"learning_rate": 1.0})
    _step(other, tmx)
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(), before)


def test_predict_score_and_reshape():
    jmod, tmod = _pair()
    x = np.random.RandomState(4).normal(size=(10,) + SHAPE[1:]) \
        .astype(np.float32)
    y = np.arange(10, dtype=np.float32) % 3
    jit = jmx.io.NDArrayIter(x, y, batch_size=4)
    tit = tmx.io.NDArrayIter(x, y, batch_size=4, ctx=CPU)
    want = jmod.predict(jit).asnumpy()
    got = tmod.predict(tit)
    assert got.shape == (10, 3)
    _close(got.asnumpy(), want)
    parts = tmod.predict(tit, merge_batches=False)
    assert [p[0].shape[0] for p in parts] == [4, 4, 2]
    assert tmod.score(tit, "acc") == pytest.approx(jmod.score(jit, "acc"))
    tmod.reshape(data_shapes=[("data", (2,) + SHAPE[1:])],
                 label_shapes=[("softmax_label", (2,))])
    tmod.forward(_batch(tmx, x[:2], y[:2]), is_train=False)
    _close(tmod.get_outputs()[0].asnumpy(), want[:2])


def test_fixed_params_and_input_grads():
    jmod, tmod = _pair({"inputs_need_grad": True},
                       fixed_param_names=["conv_weight"])
    assert tmod._exec.grad_req["conv_weight"] == "null"
    assert "conv_weight" not in tmod._exec.grad_dict
    for mod, pkg in ((jmod, jmx), (tmod, tmx)):
        mod.forward_backward(_batch(pkg))
    _close(tmod.get_input_grads()[0].asnumpy(),
           jmod.get_input_grads()[0].asnumpy())


def test_fit_callbacks_and_monitor(tmp_path, caplog):
    """``fit`` with validation, ``do_checkpoint`` every epoch,
    ``log_train_metric``, ``ProgressBar``, ``Speedometer`` and a
    ``Monitor`` on every batch; the checkpoint loads back."""
    x = np.random.RandomState(5).normal(size=(12,) + SHAPE[1:]) \
        .astype(np.float32)
    y = np.arange(12, dtype=np.float32) % 3
    train = tmx.io.NDArrayIter(x, y, batch_size=4, ctx=CPU)
    val = tmx.io.NDArrayIter(x[:8], y[:8], batch_size=4, ctx=CPU)
    tmod = _module(tmx)
    mon = tmx.monitor.Monitor(1, pattern="fc.*")
    seen = []
    prefix = str(tmp_path / "fit")
    with caplog.at_level(logging.INFO):
        tmod.fit(train, eval_data=val, num_epoch=2, monitor=mon,
                 epoch_end_callback=tmx.callback.do_checkpoint(prefix),
                 batch_end_callback=[tmx.callback.log_train_metric(1),
                                     tmx.callback.ProgressBar(3),
                                     tmx.callback.Speedometer(4, 1),
                                     lambda p: seen.append(p.nbatch)])
    assert seen == [0, 1, 2, 0, 1, 2]
    assert os.path.exists(prefix + "-0002.params")
    assert any("Validation-accuracy" in r.message for r in caplog.records)
    assert any("samples/sec" in r.message for r in caplog.records)
    _, arg, _ = tmx.model.load_checkpoint(prefix, 2, ctx=CPU)
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(),
                                  tmod.get_params()[0]["fc_weight"]
                                  .asnumpy())
    names = []
    tmod.install_monitor(type("M", (), {"install": lambda s, e:
                                        e.set_monitor_callback(
                                            lambda n, a: names.append(n))})())
    tmod.forward(_batch(tmx), is_train=False)
    assert names[-1] == "softmax_output" and "fc_output" in names


def test_several_contexts_are_refused():
    with pytest.raises(NotImplementedError, match="A8"):
        tmx.mod.Module(_net(tmx.sym), context=[CPU, CPU])
    assert tmx.mod.Module(_net(tmx.sym), context=[CPU])._device == CPU
    assert torch.device("cpu") == _module(tmx)._device
