"""``gluon.Trainer``, the kvstore, the fused step through Gluon and
``example/gluon/image_classification_torch.py`` against the JAX
package's.

- The example's loop (``hybridize``, ``autograd.record``,
  ``Trainer("sgd", momentum 0.9)`` over ``kv.create("device")``,
  ``metric.Accuracy``), built through the port example's own functions,
  against the reference example's lines on the reference's API: a
  thumbnail ResNet and ``resnet18_v1`` at 32 px, batch 4, from the
  reference's weights copied by name (``convert.params_from_gluon``) at
  lr 1e-3 (ROADMAP "Comparing steps").  As in the reference, the loss
  is averaged and ``trainer.step(batch_size)`` divides the gradients
  again.  The first step's loss agrees with the reference's within 1e-5
  relative and, after 3 steps, the accuracy is the same.  At this point
  the nets' last stage is ill-conditioned (it amplifies a difference in
  its input ~1e3x into its gradients), and the reference's forward is
  6e-6 away from an f64 run by then, so its gradients are up to 14 %
  away from the f64 run's, while the port's f32 stay within 3e-5 of it
  (ROADMAP Queue C, "noted in the reference"); so, as
  ``test_torch_zoo_mobile.py`` does, the steps are held to the port's
  f64 run of the same loop (``cast("float64")``): 3 steps of the
  thumbnail net, losses and parameters within 1e-4 relative; one step
  of ``resnet18_v1`` (its 1x1 last stage over 4 samples is chaotic in
  f32 beyond the first step: 3.5 % after 3).
- ``save_states``/``load_states``: a trainer resumed from the states
  file (written by either package) takes the step the uninterrupted one
  takes, bit for bit within the port, within 1e-6 across.
- ``Trainer.make_fused_step`` against ``make_train_step`` on a thumbnail
  ghost-BN net: equal losses and parameters, bit for bit (f32, sgd
  momentum ``multi_precision``, dynamic loss scale; and adam).  Its
  refusals.
- ``make_train_step`` takes every registered optimizer: two steps of
  each on a small dense net equal ``Trainer.step(1)`` with the same
  optimizer on the mean loss (f32, 1e-6 relative; 1e-4 for adam and
  nadam, whose fused form keeps the reference's f32 bias correction:
  ``1 - 0.999`` in f32 is 1.3e-5 off, where ``Trainer.step`` computes it
  in float64).  Static loss scales and ``nonfinite="raise"``.
- ``main(["--device", "cpu", ...])`` gives finite losses.
"""
import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.parallel import make_train_step

CPU = tmx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "image_classification_torch",
        os.path.join(REPO, "example", "gluon",
                     "image_classification_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example()


def _batches(n, size=32, batch=4, classes=10, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 3, size, size).astype(np.float32),
             rng.randint(0, classes, batch).astype(np.float32))
            for _ in range(n)]


def _reference_loop(net, batches, lr, batch_size, trainer=None,
                    metric=None):
    """The reference example's loop, line for line, on its API."""
    trainer = trainer or jgluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": lr, "momentum": 0.9},
        kvstore=jmx.kv.create("device"))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    metric = metric or jmx.metric.Accuracy()
    losses = []
    for xb, yb in batches:
        x, y = jmx.nd.array(xb), jmx.nd.array(yb)
        with jag.record():
            out = net(x)
            loss = loss_fn(out, y).mean()
        loss.backward()
        trainer.step(batch_size)
        metric.update([y], [out])
        losses.append(float(loss.asscalar()))
    return losses, metric, trainer


def _port_loop(net, args, batches, dtype=np.float32, trainer=None,
               metric=None):
    trainer = trainer or EX.build_trainer(net, args)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = metric or tmx.metric.Accuracy()
    losses = []
    for xb, yb in batches:
        loss = EX.train_batch(net, trainer, loss_fn, metric,
                              tmx.nd.array(xb.astype(dtype), ctx=CPU),
                              tmx.nd.array(yb, ctx=CPU), args.batch_size)
        losses.append(float(loss.asscalar()))
    return np.array(losses), metric, trainer


def _zoo_pair(thumbnail, args):
    """The reference's ``resnet18_v1`` (Xavier, hybridized) and the
    port's, built as the port example builds it, with the reference's
    weights copied by name."""
    jmx.random.seed(0)
    jnet = jvision.resnet18_v1(classes=10, thumbnail=thumbnail)
    jnet.initialize(init=jmx.init.Xavier())
    jnet.shape_init((1, 3, 32, 32))
    jnet.hybridize()
    if thumbnail:
        tmx.random.seed(0)
        tnet = tmx.gluon.model_zoo.vision.resnet18_v1(
            classes=10, thumbnail=True, device=CPU)
        tnet.initialize(init=tmx.init.Xavier())
        tnet.shape_init((1, 3, 32, 32))
        tnet.hybridize()
    else:
        tnet = EX.build_net(args, CPU)
    convert.params_from_gluon(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    assert convert.canonical_names(list(jnet.collect_params())) == \
        convert.canonical_names(list(tnet.collect_params()))
    return jnet, tnet


def _momenta(trainer, i):
    return trainer._updaters[0].states[i].asnumpy()


def _example_args():
    return EX.parse_args(["--device", "cpu", "--batch-size", "4",
                          "--lr", "1e-3"])


@pytest.mark.parametrize("thumbnail", [True, False],
                         ids=["thumbnail", "resnet18_v1"])
def test_example_loop_matches_reference(thumbnail):
    """One step of the example's loop against the reference's, then two
    more.  After step 1 the momentum of each parameter is its update,
    ``-lr * grad / batch_size`` with ``grad`` that of the averaged loss
    (the batch divides twice, as in the reference), free of the
    cancellation of ``after - before``; that difference must equal it
    within half an ulp of the weight, so the update landed in the
    module's tensor."""
    args = _example_args()
    jnet, tnet = _zoo_pair(thumbnail, args)
    fresh = copy.deepcopy(tnet)
    before = _values(tnet)
    batches = _batches(3)
    jlosses, jmetric, jtr = _reference_loop(jnet, batches[:1], 1e-3, 4)
    tlosses, tmetric, ttr = _port_loop(tnet, args, batches[:1])
    # measured: 8.9e-7 (thumbnail), 3.6e-7 (resnet18_v1)
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    jparams = list(jnet.collect_params().items())
    tparams = list(tnet.collect_params().values())
    for i, ((k, jp), tp, w0) in enumerate(zip(jparams, tparams, before)):
        got, want = tp.data().asnumpy(), jp.data().asnumpy()
        if tp.grad_req == "null":
            # running stats come from the forward alone, which agrees
            # to ~6e-6 relative
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        tm, jm = _momenta(ttr, i), _momenta(jtr, i)
        step = got.astype(np.float64) - w0
        assert np.all(np.abs(step - tm) <= 0.5 * np.spacing(
            np.maximum(np.abs(w0), np.abs(got)))), k
        if k.startswith("dense"):
            # the output Dense's gradient depends on the forward alone
            # (measured: 3.5e-5 of the largest element)
            np.testing.assert_allclose(tm, jm, rtol=1e-4,
                                       atol=1e-4 * np.abs(jm).max(),
                                       err_msg=k)
        else:
            # below the output Dense the gradients are ill-conditioned
            # here: a 1e-5 relative change of the input moves the
            # port's own float64 gradients of the thumbnail net by
            # percent (test_example_loop_gradients_are_ill_conditioned),
            # and the reference's forward is 6e-6 from float64 (ROADMAP
            # Queue C).  Measured: at most 1.5 %
            # (thumbnail) and 2.3 % (resnet18_v1) by norm.  A
            # misrouted, unscaled or missing gradient is off by its
            # own size.
            err = np.linalg.norm(tm - jm) / np.linalg.norm(jm)
            assert err < 5e-2, (k, err)
    # Trainer.step(batch_size) alone: the reference's gradients written
    # into the port's gradient buffers give the reference's step,
    # momentum and weights, bit for bit
    ftr = EX.build_trainer(fresh, args)
    fparams = list(fresh.collect_params().values())
    for tp, (_, jp) in zip(fparams, jparams):
        if tp.grad_req != "null":
            tp.grad()._data = torch.from_numpy(jp.grad().asnumpy().copy())
    ftr.step(args.batch_size)
    for i, ((k, jp), tp) in enumerate(zip(jparams, fparams)):
        if tp.grad_req == "null":
            continue
        np.testing.assert_array_equal(_momenta(ftr, i), _momenta(jtr, i),
                                      err_msg=k)
        np.testing.assert_array_equal(tp.data().asnumpy(),
                                      jp.data().asnumpy(), err_msg=k)
    # steps 2-3 (held to the port's float64 run below): the same
    # accuracy as the reference's
    _, jmetric, _ = _reference_loop(jnet, batches[1:], 1e-3, 4,
                                    trainer=jtr, metric=jmetric)
    _, tmetric, _ = _port_loop(tnet, args, batches[1:], trainer=ttr,
                               metric=tmetric)
    assert tmetric.get() == jmetric.get()


def test_example_loop_gradients_are_ill_conditioned():
    """The premise of the 5e-2 above: in float64, with no rounding to
    speak of, a 1e-5 relative change of the input (the reference's
    forward is 6e-6 from float64) moves the thumbnail net's gradients by
    percent (measured: 0.19 %, 2.3 % and 8.4 % for 1e-6, 1e-5 and 1e-4,
    worst parameter by norm)."""
    _, tnet = _zoo_pair(True, _example_args())
    tnet.cast("float64")
    xb, yb = _batches(1)[0]
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()

    def grads(x):
        net = copy.deepcopy(tnet)
        with tmx.autograd.record():
            loss = loss_fn(net(tmx.nd.array(x, ctx=CPU)),
                           tmx.nd.array(yb, ctx=CPU)).mean()
        loss.backward()
        return [p.grad().asnumpy() for p in net.collect_params().values()
                if p.grad_req != "null"]

    x = xb.astype(np.float64)
    g0 = grads(x)
    noise = np.random.RandomState(1).standard_normal(x.shape)
    moved = [max(np.linalg.norm(a - b) / np.linalg.norm(b)
                 for a, b in zip(grads(x * (1 + eps * noise)), g0))
             for eps in (1e-6, 1e-5, 1e-4)]
    assert moved[0] < moved[1] < moved[2]
    assert moved[1] > 1e-2, moved


@pytest.mark.parametrize("thumbnail", [True, False],
                         ids=["thumbnail", "resnet18_v1"])
def test_example_loop_steps_match_float64(thumbnail):
    """The example's loop against the port's float64 run of it
    (``cast("float64")``): 3 steps of the thumbnail net and one of
    ``resnet18_v1`` (its 1x1 last stage over 4 samples is chaotic in
    f32 beyond the first step: 3.5 % after 3), losses and parameters
    within 1e-4 relative."""
    args = _example_args()
    _, tnet = _zoo_pair(thumbnail, args)
    t64 = copy.deepcopy(tnet)
    t64.cast("float64")
    batches = _batches(3 if thumbnail else 1)
    tlosses, _, _ = _port_loop(tnet, args, batches)
    losses64, _, _ = _port_loop(t64, args, batches, np.float64)
    np.testing.assert_allclose(tlosses, losses64, rtol=1e-4)
    for (k, tp), p64 in zip(tnet.collect_params().items(),
                            t64.collect_params().values()):
        np.testing.assert_allclose(tp.data().asnumpy(), p64.data().asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _dense_net(pkg, seed=0, use_bias=True):
    ctx = context.device_scope("cpu") if pkg is tmx else _null()
    with ctx:
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(8, in_units=6, activation="tanh",
                                   use_bias=use_bias),
                pkg.gluon.nn.Dense(3, in_units=8, use_bias=use_bias))
    net.initialize()
    rng = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(
            rng.normal(size=p.shape).astype(np.float32) * 0.5,
            **({"ctx": CPU} if pkg is tmx else {})))
    return net


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _trainer_steps(pkg, net, opt, opt_params, batches, trainer=None):
    kw = {"ctx": CPU} if pkg is tmx else {}
    trainer = trainer or pkg.gluon.Trainer(net.collect_params(), opt,
                                           dict(opt_params))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for xb, yb in batches:
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(xb, **kw)),
                           pkg.nd.array(yb, **kw)).mean()
        loss.backward()
        trainer.step(1)
    return trainer


def _dense_batches(n, seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.normal(size=(5, 6)).astype(np.float32),
             rng.randint(0, 3, 5).astype(np.float32)) for _ in range(n)]


def _values(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_states_resumes(tmp_path, writer):
    opt_params = {"learning_rate": 0.1, "beta1": 0.8}
    batches = _dense_batches(3)
    pkg = tmx if writer == "port" else jmx
    net = _dense_net(pkg)
    tr = _trainer_steps(pkg, net, "adam", opt_params, batches[:2])
    tr.save_states(str(tmp_path / "s.states"))
    resumed = _dense_net(tmx)
    for p, v in zip(resumed.collect_params().values(), _values(net)):
        p.set_data(tmx.nd.array(v, ctx=CPU))
    tr2 = tmx.gluon.Trainer(resumed.collect_params(), "adam",
                            dict(opt_params))
    tr2.load_states(str(tmp_path / "s.states"))
    tr2.optimizer._index_update_count = dict(
        tr.optimizer._index_update_count)
    tr2.optimizer.num_update = tr.optimizer.num_update
    _trainer_steps(pkg, net, "adam", opt_params, batches[2:], trainer=tr)
    _trainer_steps(tmx, resumed, "adam", opt_params, batches[2:],
                   trainer=tr2)
    for a, b in zip(_values(resumed), _values(net)):
        if writer == "port":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


ALL_OPTIMIZERS = ["sgd", "nag", "adam", "adagrad", "rmsprop", "adadelta",
                  "ftrl", "adamax", "nadam", "signum", "signsgd", "ftml",
                  "lamb", "dcasgd", "lbsgd", "adamw", "lars", "sgld",
                  "ccsgd", "groupadagrad"]


@pytest.mark.parametrize("name", ALL_OPTIMIZERS)
def test_fused_step_takes_every_optimizer(name):
    """Two fused steps (``make_train_step``) equal ``Trainer.step(1)``
    of the same optimizer on a mean loss."""
    kw = {"learning_rate": 0.05}
    if name in ("sgd", "nag", "dcasgd", "lbsgd", "lars", "signum"):
        kw["momentum"] = 0.9
    batches = _dense_batches(2)
    # GroupAdaGrad takes 2-D weights only, as in the reference
    net = _dense_net(tmx, use_bias=name != "groupadagrad")
    fused = copy.deepcopy(net)
    tmx.random.seed(1)
    _trainer_steps(tmx, net, name, kw, batches)
    step = make_train_step(fused, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer=name, device="cpu", **kw)
    tmx.random.seed(1)
    for xb, yb in batches:
        step(torch.from_numpy(xb), torch.from_numpy(yb))
    got = dict(fused.named_parameters())
    for sname, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(got[sname].detach().numpy(),
                                   p.data().asnumpy(),
                                   rtol=1e-4 if name in ("adam", "nadam")
                                   else 1e-6, atol=1e-7, err_msg=sname)


def _ghost_net():
    with context.device_scope("cpu"):
        net = tmx.gluon.model_zoo.vision.resnet.ResNetV1(
            tmx.gluon.model_zoo.vision.resnet.BasicBlockV1, [1, 1],
            [8, 8, 16], classes=10, thumbnail=True, ghost_bn=2)
    tmx.initializer.initialize(net, tmx.init.Xavier(),
                               torch.Generator().manual_seed(0))
    net.shape_init((1, 3, 16, 16))
    return net


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"momentum": 0.9, "wd": 1e-4, "multi_precision": True}),
    ("adam", {"beta1": 0.8})], ids=["sgd_mp", "adam"])
def test_fused_step_through_gluon_matches_train_step(opt, kw):
    net = _ghost_net()
    twin = copy.deepcopy(net)
    trainer = tmx.gluon.Trainer(net.collect_params(), opt,
                                dict(kw, learning_rate=0.01))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    fused = trainer.make_fused_step(net, loss_fn, loss_scale="dynamic",
                                    device="cpu")
    plain = make_train_step(twin, loss_fn, optimizer=opt, device="cpu",
                            learning_rate=0.01, loss_scale="dynamic", **kw)
    rng = np.random.RandomState(8)
    for _ in range(3):
        x = torch.from_numpy(rng.rand(4, 3, 16, 16).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 10, 4).astype(np.float32))
        assert torch.equal(fused(x, y), plain(x, y))
    for (k, a), (_, b) in zip(net.named_parameters(),
                              twin.named_parameters()):
        assert torch.equal(a, b), k


def test_make_fused_step_refusals():
    net = _dense_net(tmx)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(net.collect_params().values())
    with pytest.raises(ValueError, match="without"):
        tmx.gluon.Trainer(params[:2], "sgd").make_fused_step(net, loss_fn)
    params[0].lr_mult = 2.0
    with pytest.raises(ValueError, match="lr_mult"):
        tmx.gluon.Trainer(params, "sgd").make_fused_step(net, loss_fn)
    params[0].lr_mult = 1.0
    sched = tmx.lr_scheduler.FactorScheduler(step=10)
    with pytest.raises(ValueError, match="scheduler"):
        tmx.gluon.Trainer(params, "sgd", {"lr_scheduler": sched}) \
            .make_fused_step(net, loss_fn)


def test_static_loss_scale_and_nonfinite_raise():
    batches = _dense_batches(2)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets = [_dense_net(tmx) for _ in range(2)]
    steps = [make_train_step(n, loss_fn, device="cpu", learning_rate=0.1,
                             momentum=0.9, loss_scale=ls)
             for n, ls in zip(nets, (None, 128.0))]
    for xb, yb in batches:
        a, b = (s(torch.from_numpy(xb), torch.from_numpy(yb))
                for s in steps)
        assert torch.equal(a, b)
    for a, b in zip(*(n.parameters() for n in nets)):
        assert torch.equal(a, b)
    step = make_train_step(nets[0], loss_fn, device="cpu", learning_rate=0.1,
                           nonfinite="raise")
    before = [t.detach().clone() for t in nets[0].parameters()]
    xb = np.full((5, 6), np.nan, np.float32)
    with pytest.raises(FloatingPointError):
        step(torch.from_numpy(xb), torch.from_numpy(batches[0][1]))
    assert step.step_count == 0 and step.skipped_steps == 1
    for a, b in zip(nets[0].parameters(), before):
        assert torch.equal(a, b)


def test_kvstore_single_process():
    kv = tmx.kv.create("device")
    kv.init(3, tmx.nd.ones((2, 2), ctx=CPU))
    kv.push(3, [tmx.nd.ones((2, 2), ctx=CPU) * 2,
                tmx.nd.ones((2, 2), ctx=CPU)])
    out = tmx.nd.zeros((2, 2), ctx=CPU)
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 3.0))
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.5))
    kv.pushpull(3, tmx.nd.ones((2, 2), ctx=CPU), out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 2.5))
    # without a launcher environment a dist store is single-worker
    with pytest.warns(UserWarning, match="launcher environment"):
        dist = tmx.kv.create("dist_sync_device")
    assert (dist.rank, dist.num_workers) == (0, 1)

    @tmx.kv.KVStoreBase.register
    class Plugged(tmx.kv.KVStore):
        pushed = 0

        def pushpull(self, key, value, out=None, priority=0):
            Plugged.pushed += 1

    net = _dense_net(tmx)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore="plugged")
    _trainer_steps(tmx, net, "sgd", {}, _dense_batches(1), trainer=tr)
    assert Plugged.pushed == 4


def test_example_main_on_cpu():
    losses = EX.main(["--device", "cpu", "--epochs", "1", "--samples", "8",
                      "--batch-size", "4", "--image-size", "16"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_trainer_learning_rate_and_package_names():
    net = _dense_net(tmx)
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.2, "lr_scheduler": sched})
    assert tr.learning_rate == 0.2
    _trainer_steps(tmx, net, "sgd", {}, _dense_batches(3), trainer=tr)
    assert tr.optimizer.num_update == 3 and tr.learning_rate == 0.05
    tr2 = tmx.gluon.Trainer(net.collect_params(), "sgd")
    tr2.set_learning_rate(0.3)
    assert tr2.learning_rate == 0.3
    tr2.zero_grad()
    assert all(not p.grad().asnumpy().any()
               for p in net.collect_params().values())
    assert tmx.init is tmx.initializer and tmx.kv is tmx.kvstore
    assert tmx.gluon.Parameter is tmx.gluon.parameter.Parameter
    assert isinstance(tmx.optimizer.create("groupadagrad"),
                      tmx.optimizer.GroupAdaGrad)
    assert isinstance(tmx.init.registry_create("uniform"),
                      tmx.init.Uniform)
