"""The port's optimizers against the JAX package's.

Every registered optimizer (the 19 of ``optimizer/optimizer.py`` and
``contrib.GroupAdaGrad``) runs 3 updates through each package's
``Updater`` on the same weight and the same three gradients (numpy seed
0), in four settings: plain; with ``multi_precision`` on a float16
weight (f32 master weight, the reference's rule); with weight decay,
per-name lr/wd multipliers (``set_lr_mult``/``set_wd_mult``) and
``clip_gradient``; with an lr scheduler (``FactorScheduler``).  SGLD's
noise is the same numpy draw on both sides (each package's normal draw
patched), since the two generators differ.

Tolerance: f32 results within 1e-6 relative (plus 1e-7 absolute for
values near 0), but 3e-5 relative for FTML: the reference's update op
is compiled with ``t`` a constant, and XLA folds ``beta2 ** t`` one f32
ulp away from the correctly rounded power that the port computes;
``1 - beta2 ** t`` (0.003 at t = 3) turns that ulp into 1e-5 of
``d_t``.  The float16 weights of the ``multi_precision`` runs
within one float16 rounding of each other (the f32 masters within
1e-6).  ``Updater.get_states``/``set_states`` round trips resume an
update bit for bit within the port and across the packages.  The four lr
schedulers give the reference's rates.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.optimizer import optimizer as topt

CPU = tmx.cpu()
SHAPE = (6, 5)

# name -> constructor keywords beyond the defaults
OPTIMIZERS = {
    "sgd": {"momentum": 0.9}, "nag": {"momentum": 0.9}, "adam": {},
    "adagrad": {}, "rmsprop": {}, "adadelta": {}, "ftrl": {},
    "adamax": {}, "nadam": {}, "signum": {}, "signsgd": {}, "ftml": {},
    "lamb": {}, "dcasgd": {"momentum": 0.9}, "lbsgd": {"momentum": 0.9},
    "adamw": {}, "lars": {"momentum": 0.9}, "sgld": {}, "ccsgd": {},
    "groupadagrad": {},
}
EXTRA = {"rmsprop": {"centered": True, "clip_weights": 2.0},
         "lamb": {"lower_bound": 0.1, "upper_bound": 10.0}}
SETTINGS = ["plain", "multi_precision", "mults_clip", "scheduler"]


def _rtol(name):
    return 3e-5 if name == "ftml" else 1e-6


def _data(dtype):
    rng = np.random.RandomState(0)
    w = rng.normal(size=SHAPE).astype(dtype)
    grads = [rng.normal(size=SHAPE).astype(dtype) for _ in range(3)]
    return w, grads


def _kwargs(pkg, name, setting):
    kw = dict(OPTIMIZERS[name], learning_rate=0.05)
    if setting == "mults_clip":
        kw.update(EXTRA.get(name, {}), clip_gradient=0.5,
                  param_idx2name={0: "fc_weight"}, rescale_grad=0.5)
        if name != "groupadagrad":
            kw["wd"] = 1e-2
    if setting == "multi_precision":
        kw["multi_precision"] = True
    if setting == "scheduler":
        kw["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(step=1,
                                                             factor=0.5)
    return kw


def _optimizer(pkg, name, setting):
    opt = pkg.optimizer.create(name, **_kwargs(pkg, name, setting))
    if setting == "mults_clip":
        opt.set_lr_mult({"fc_weight": 0.5})
        opt.set_wd_mult({"fc_weight": 2.0})
    return opt


NOISE = np.random.RandomState(7).normal(size=(3,) + SHAPE)


@pytest.fixture(autouse=True)
def same_noise(monkeypatch):
    """SGLD's noise: the same numpy normals, scaled, on both sides, in
    the order each side draws them."""
    count = {"jax": 0, "port": 0}

    def draw(side, scale):
        z = NOISE[count[side] % len(NOISE)]
        count[side] += 1
        return (z * scale).astype(np.float32)

    def jnormal(loc=0.0, scale=1.0, shape=None, dtype=None, **kw):
        return jmx.nd.array(draw("jax", scale))

    def tnoise(weight, scale):
        return torch.from_numpy(draw("port", scale)).to(weight.dtype)

    monkeypatch.setattr(jmx.random, "normal", jnormal)
    monkeypatch.setattr(topt.SGLD, "_noise", staticmethod(tnoise))


def _run(pkg, name, setting, w, grads, ctx=None):
    opt = _optimizer(pkg, name, setting)
    updater = pkg.optimizer.get_updater(opt)
    weight = pkg.nd.array(w, ctx=ctx) if ctx else pkg.nd.array(w)
    for g in grads:
        grad = pkg.nd.array(g, ctx=ctx) if ctx else pkg.nd.array(g)
        updater(0, grad, weight)
    return weight.asnumpy(), updater


def _leaves(state):
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [] if state is None else [state.asnumpy()]


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_reference(name, setting):
    mp = setting == "multi_precision"
    w, grads = _data(np.float16 if mp else np.float32)
    jw, jup = _run(jmx, name, setting, w, grads)
    tw, tup = _run(tmx, name, setting, w, grads, ctx=CPU)
    assert tw.dtype == jw.dtype
    if mp:
        np.testing.assert_allclose(tw.astype(np.float32),
                                   jw.astype(np.float32), rtol=1e-3,
                                   atol=1e-3)
    else:
        np.testing.assert_allclose(tw, jw, rtol=_rtol(name), atol=1e-7)
    jstate, tstate = _leaves(jup.states[0]), _leaves(tup.states[0])
    assert len(jstate) == len(tstate)
    for a, b in zip(tstate, jstate):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=_rtol(name), atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "dcasgd",
                                  "ftml", "nadam"])
def test_states_round_trip(name):
    """``get_states`` after two updates, ``set_states`` in a fresh
    updater (the port's, and the port's from the reference's): the third
    update matches the uninterrupted one."""
    w, grads = _data(np.float32)
    kw = dict(OPTIMIZERS[name], learning_rate=0.05,
              **EXTRA.get(name, {}))
    results = {}
    for src in ("port", "jax"):
        pkg = tmx if src == "port" else jmx
        nd_kw = {"ctx": CPU} if src == "port" else {}
        opt = pkg.optimizer.create(name, **kw)
        up = pkg.optimizer.get_updater(opt)
        weight = pkg.nd.array(w, **nd_kw)
        for g in grads[:2]:
            up(0, pkg.nd.array(g, **nd_kw), weight)
        blob = up.get_states()
        # resume in the port from either package's states
        opt2 = tmx.optimizer.create(name, **kw)
        opt2._index_update_count = dict(opt._index_update_count)
        opt2.num_update = opt.num_update
        if name == "nadam":
            opt2.m_schedule = float(opt.m_schedule)
        up2 = tmx.optimizer.get_updater(opt2)
        up2.set_states(blob, ctx=CPU)
        w2 = tmx.nd.array(weight.asnumpy(), ctx=CPU)
        up2(0, tmx.nd.array(grads[2], ctx=CPU), w2)
        up(0, pkg.nd.array(grads[2], **nd_kw), weight)
        results[src] = (w2.asnumpy(), weight.asnumpy())
    np.testing.assert_array_equal(*results["port"])
    np.testing.assert_allclose(*results["jax"], rtol=_rtol(name),
                               atol=1e-7)


def test_update_writes_into_the_weight_tensor():
    """An update through a Parameter's data() keeps its tensor."""
    p = tmx.gluon.Parameter("w", shape=SHAPE)
    p.initialize(ctx=CPU)
    t = p.data()._data
    up = tmx.optimizer.get_updater(tmx.optimizer.create(
        "adam", learning_rate=0.1))
    p.grad()._data = torch.ones(SHAPE)
    before = t.detach().clone()
    up(0, p.grad(), p.data())
    assert p.data()._data is t and not torch.equal(t, before)


def test_create_refuses_unknown_names():
    with pytest.raises(ValueError):
        tmx.optimizer.create("nosuch")


@pytest.mark.parametrize("name,kw", [
    ("FactorScheduler", {"step": 2, "factor": 0.5, "stop_factor_lr": 1e-3}),
    ("MultiFactorScheduler", {"step": [2, 5], "factor": 0.1}),
    ("PolyScheduler", {"max_update": 8, "pwr": 2, "final_lr": 1e-4,
                       "warmup_steps": 2}),
    ("CosineScheduler", {"max_update": 8, "final_lr": 1e-4,
                         "warmup_steps": 3, "warmup_mode": "constant"}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_lr_schedulers_match_reference(name, kw):
    """Each scheduler gives the reference's learning rate at update
    counts 0-11 (host floats, equal)."""
    got = {}
    for pkg in (jmx, tmx):
        sched = getattr(pkg.lr_scheduler, name)(base_lr=0.1, **kw)
        got[pkg] = [sched(n) for n in range(12)]
    assert got[tmx] == got[jmx]
