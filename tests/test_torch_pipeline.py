"""The port's pipeline parallelism against the JAX package, on the CPU.

One job of 4 ranks over gloo (``tools/launch_torch.py``,
``tests/torch_mp_worker.py`` in mode ``pipeline``, which imports no JAX)
runs every multi-process case; the parent runs the reference on its
8-device CPU mesh meanwhile, from the same numpy seeds and the JAX nets'
initial weights.

- ``pipeline_apply`` at pp=4 (the reference's
  ``tests/test_parallel.py::test_pipeline_matches_sequential``: 4 tanh
  stages of width 8, batch 16, 4 microbatches): output within rtol 1e-5
  / atol 1e-6, the stacked parameters' gradients of ``sum(out * cot)``
  within 1e-5;
- one step of ``make_train_step(pipeline_stages=K, num_micro=4)`` at
  unit lr (the gradient is ``before - after``) on the reference's
  ``tests/test_pipeline_train.py`` net (4 ``Dense(16, tanh)``, batch 16)
  at pp=4 (K 4) and at dp=2 x pp=2 (K 2), remat off and on, against the
  reference's pipelined step on the same mesh: loss and every gradient
  within 1e-5 (rtol and atol), remat equal to no remat bit for bit, the
  ranks' gradients equal bit for bit, and the collectives a step;
- ``Trainer.make_fused_step(mesh=, pipeline_stages=4, num_micro=4)``,
  2 steps at lr 0.1, momentum 0.9: losses within rtol 1e-5 / atol 1e-6
  and parameters within 1e-5 of the reference's; its checkpoint restores
  at pp=4 bit for bit and is refused at pp=2;
- the refusals, in this process over a mesh object of 4 ranks without
  groups (every check runs before a collective).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.parallel import make_mesh as jmesh
from incubator_mxnet_tpu.parallel import make_train_step as jmake
from incubator_mxnet_tpu.parallel.pipeline import \
    pipeline_apply as jpipeline_apply

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.contrib.nn import MoEFFN
from incubator_mxnet_tpu_torch.parallel import (Mesh, make_train_step,
                                                stack_stage_params)

import torch_dist_launch

RANKS = 4
FEAT = 16
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
STEP_CASES = [("pp4", {"pp": 4}), ("dp2pp2", {"dp": 2, "pp": 2})]


def _jax_net():
    """The reference's ``test_pipeline_train._build()``."""
    jmx.random.seed(3)
    net = jnn.HybridSequential()
    for _ in range(4):
        net.add(jnn.Dense(FEAT, activation="tanh"))
    net.initialize(init=jmx.init.Xavier())
    net(nd.ones((2, FEAT)))
    return net


def _batch():
    rng = np.random.RandomState(0)
    return (rng.rand(16, FEAT).astype(np.float32),
            (np.arange(16) % 4).astype(np.float32))


def _values(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def _apply_inputs():
    rng = np.random.RandomState(0)
    return {"apply.ws": rng.normal(0, 0.5, (4, 8, 8)).astype(np.float32),
            "apply.bs": rng.normal(0, 0.1, (4, 8)).astype(np.float32),
            "apply.x": rng.normal(size=(16, 8)).astype(np.float32),
            "apply.cot": rng.normal(size=(16, 8)).astype(np.float32)}


def _reference_apply(inputs):
    mesh = jmesh({"pp": 4}, devices=jax.devices()[:4])
    ws, bs, x, cot = (jnp.asarray(inputs["apply." + k])
                      for k in ("ws", "bs", "x", "cot"))

    def stage_fn(params, h):
        w, b = params
        return jnp.tanh(h @ w + b)

    def f(ws, bs):
        return jpipeline_apply(stage_fn, (ws, bs), x, mesh, num_micro=4)

    out = f(ws, bs)
    dws, dbs = jax.grad(lambda ws, bs: jnp.sum(f(ws, bs) * cot),
                        argnums=(0, 1))(ws, bs)
    return np.asarray(out), np.asarray(dws), np.asarray(dbs)


def _reference_steps(x, y):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for name, axes in STEP_CASES:
        mesh = jmesh(axes, devices=jax.devices()[:RANKS])
        net = _jax_net()
        before = _values(net)
        step = jmake(net, loss_fn, optimizer="sgd", learning_rate=1.0,
                     mesh=mesh, pipeline_stages=axes["pp"], num_micro=4,
                     lint="off")
        loss = float(step(nd.array(x), nd.array(y)).asscalar())
        out[name] = (loss, [b - a for b, a in zip(before, _values(net))])
    net = _jax_net()
    trainer = jgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    step = trainer.make_fused_step(
        net, loss_fn, mesh=jmesh({"pp": 4}, devices=jax.devices()[:4]),
        pipeline_stages=4, num_micro=4, lint="off")
    losses = [float(step(nd.array(x), nd.array(y)).asscalar())
              for _ in range(2)]
    out["trainer"] = (losses, _values(net))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("pipeline")
    x, y = _batch()
    inputs = dict(_apply_inputs())
    for i, w in enumerate(_values(_jax_net())):
        inputs["pipe.w%d" % i] = w
    inputs["pipe.x"], inputs["pipe.y"] = x, y
    np.savez(os.path.join(str(outdir), "inputs.npz"), **inputs)
    proc = torch_dist_launch.start("pipeline", outdir, ranks=RANKS,
                                   worker=torch_dist_launch.MP_WORKER)
    try:
        ref = {"apply": _reference_apply(inputs)}
        ref.update(_reference_steps(x, y))
    except BaseException:
        proc.kill()
        raise
    return torch_dist_launch.finish(proc, outdir, ranks=RANKS), ref


def test_pipeline_apply_matches_reference(job):
    ranks, ref = job
    out, dws, dbs = ref["apply"]
    for r in ranks:
        np.testing.assert_allclose(r["apply.out"], out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["apply.dws"], dws, **TOL)
    np.testing.assert_allclose(ranks[0]["apply.dbs"], dbs, **TOL)
    for r in ranks[1:]:
        assert r["apply.dws"].tobytes() == ranks[0]["apply.dws"].tobytes()
    # 7 ticks: 7 ppermutes forward, 6 backward (the last tick's output
    # is not used); one masked all_reduce of the outputs; the stacked
    # parameters' gradients all-gathered
    assert json.loads(str(ranks[0]["apply.calls"])) == \
        {"all_gather": 2, "all_reduce": 1, "ppermute": 13}


def _grads(rank, key):
    return [rank["%s.g%d" % (key, i)] for i in range(8)]


@pytest.mark.parametrize("remat", [0, 1])
@pytest.mark.parametrize("name", [n for n, _ in STEP_CASES])
def test_pipelined_step_grads_match_reference(job, name, remat):
    ranks, ref = job
    loss, grads = ref[name]
    key = "%s_remat%d" % (name, remat)
    got = ranks[0]
    assert abs(float(got[key + ".loss"]) - loss) < 1e-5
    for i, (a, b) in enumerate(zip(_grads(got, key), grads)):
        np.testing.assert_allclose(a, b, err_msg="param %d" % i, **TOL)
    for r in ranks[1:]:
        for a, b in zip(_grads(r, key), _grads(got, key)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", [n for n, _ in STEP_CASES])
def test_remat_equals_no_remat(job, name):
    for r in job[0]:
        assert float(r[name + "_remat0.loss"]) == \
            float(r[name + "_remat1.loss"])
        for a, b in zip(_grads(r, name + "_remat0"),
                        _grads(r, name + "_remat1")):
            assert a.tobytes() == b.tobytes()


def test_pipelined_step_collectives(job):
    """A step at pp=4: 7 ticks, 13 ppermutes, one all_reduce of the
    outputs and one of the gradients over pp.  At dp=2 x pp=2: 5 ticks,
    9 ppermutes, the same two all_reduces and the dp one, and the batch
    check's all_gather."""
    r0 = job[0][0]
    for remat in (0, 1):
        assert json.loads(str(r0["pp4_remat%d.calls" % remat])) == \
            {"all_reduce": 2, "ppermute": 13}
        assert json.loads(str(r0["dp2pp2_remat%d.calls" % remat])) == \
            {"all_gather": 1, "all_reduce": 3, "ppermute": 9}


def test_trainer_fused_step_pipeline_keywords(job):
    ranks, ref = job
    losses, params = ref["trainer"]
    for r in ranks:
        np.testing.assert_allclose(r["trainer.loss"], losses, rtol=1e-5,
                                   atol=1e-6)
        for i, want in enumerate(params):
            np.testing.assert_allclose(r["trainer.p%d" % i], want, **TOL)


def test_checkpoint_restores_at_pp4_refused_at_pp2(job):
    for r in job[0]:
        assert int(r["ckpt.restored"]) == 2
        for i in range(8):
            assert r["ckpt.p%d" % i].tobytes() == \
                r["trainer.p%d" % i].tobytes()
        msg = str(r["ckpt.refusal"])
        assert msg.startswith("CheckpointTopologyError") and \
            "pipeline_stages 4 != 2" in msg, msg


# ---------------------------------------------------------------------------
# refusals, in this process
# ---------------------------------------------------------------------------

def _fake(axes):
    """A mesh object of 4 ranks with no process groups: this process is
    rank 0; its collectives make no backend call."""
    return Mesh(tuple(axes), list(axes.values()), [CPU] * RANKS,
                [None] * len(axes))


def _stack(blocks):
    tmx.random.seed(0)
    with context.device_scope("cpu"):
        net = tnn.HybridSequential()
        net.add(*blocks())
    net.initialize(init=tmx.init.Xavier())
    return net


def _step(net, mesh, **kw):
    kw.setdefault("pipeline_stages", 4)
    kw.setdefault("num_micro", 2)
    return make_train_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer="sgd", device="cpu", mesh=mesh, **kw)


def _dense4():
    return [tnn.Dense(FEAT, in_units=FEAT, activation="tanh")
            for _ in range(4)]


def test_refuses_stages_that_are_not_congruent():
    net = _stack(lambda: [tnn.Dense(32, in_units=FEAT, activation="relu"),
                          tnn.Dense(FEAT, in_units=32),
                          tnn.Dense(8, in_units=FEAT),
                          tnn.Dense(4, in_units=8)])
    with pytest.raises(ValueError, match="congruent"):
        _step(net, _fake({"pp": 4}))


def test_refuses_aux_state_in_a_stage():
    def blocks():
        out = []
        for _ in range(4):
            sub = tnn.HybridSequential()
            sub.add(tnn.Dense(FEAT, in_units=FEAT),
                    tnn.BatchNorm(in_channels=FEAT))
            out.append(sub)
        return out

    with pytest.raises(NotImplementedError, match="auxiliary state"):
        _step(_stack(blocks), _fake({"pp": 4}))


def test_refuses_aux_losses_in_a_stage():
    net = _stack(lambda: [MoEFFN(8, 2, in_units=FEAT) for _ in range(4)])
    step = _step(net, _fake({"pp": 4}))
    x, y = _batch()
    with pytest.raises(NotImplementedError, match="aux losses inside"):
        step(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("mesh,kw,match", [
    (None, {}, "requires a mesh with a 'pp' axis"),
    ({"dp": 4}, {}, "has no 'pp' axis"),
    ({"pp": 4}, {"pipeline_stages": 2}, "pipeline_stages=2 but mesh axis"),
    ({"pp": 4}, {"num_micro": 0}, "num_micro must be >= 1"),
])
def test_refuses_pipeline_arguments(mesh, kw, match):
    with pytest.raises(ValueError, match=match):
        _step(_stack(_dense4), None if mesh is None else _fake(mesh), **kw)


def test_refuses_a_net_that_cannot_be_split():
    net = _stack(lambda: _dense4()[:3])
    with pytest.raises(ValueError, match="cannot split 3 child blocks"):
        _step(net, _fake({"pp": 4}))
    with context.device_scope("cpu"):
        lone = tnn.Dense(FEAT, in_units=FEAT)
    lone.initialize()
    with pytest.raises(ValueError, match="iterable stacked net"):
        _step(lone, _fake({"pp": 4}))


def test_refuses_a_batch_that_does_not_split_into_microbatches():
    step = _step(_stack(_dense4), _fake({"pp": 4}), num_micro=3)
    x, y = _batch()
    with pytest.raises(ValueError, match="not divisible into num_micro=3"):
        step(torch.from_numpy(x), torch.from_numpy(y))


def test_stack_stage_params_congruence():
    a = [torch.ones(3, 4), torch.zeros(4)]
    b = [torch.full((3, 4), 2.0), torch.ones(4)]
    stacked = stack_stage_params([a, b])
    assert [tuple(s.shape) for s in stacked] == [(2, 3, 4), (2, 4)]
    assert float(stacked[0][1].max()) == 2.0
    with pytest.raises(ValueError, match="congruent"):
        stack_stage_params([a, [torch.ones(3, 5), torch.zeros(4)]])
    with pytest.raises(ValueError, match="identical"):
        stack_stage_params([a, [torch.ones(3, 4)]])
