"""The port's mixture of experts, expert and tensor sharding against the
JAX package, on the CPU.

In this process, ``moe_ffn`` against the reference's (its
``tests/test_pipeline_train.py`` shapes: 32 tokens, width 8, 4 experts,
hidden 12): top-k 1 and 2, without capacity and at capacity factors 100
and 0.5, outputs within rtol 1e-5 / atol 1e-6, the load-balancing loss
within rtol 1e-6, the gradients of ``sum(out * cot) + aux`` within rtol
1e-4 / atol 1e-5; the bf16 capacity gate (600 decisions to one expert,
capacity 150: exactly 150 kept, the reference's rows); ties in the
router's probabilities broken to the lower expert as ``jax.lax.top_k``
does; the refusals; ``MoEFFN`` in a one-process step (its aux loss in
the objective) against the reference's step, losses within rtol 1e-5.

One job of 4 ranks over gloo (``tests/torch_mp_worker.py`` in mode
``moe``, which imports no JAX) runs the sharded cases while the parent
runs the reference on its 8-device CPU mesh:

- ``moe_ffn_sharded`` at ep=2 (16 tokens, top-2, capacity factor 2)
  against the reference's at ep=2: outputs rtol 1e-4 / atol 1e-5 (the
  reference's own gate), aux rtol 1e-5, gradients rtol 1e-4 / atol
  1e-5;
- ``MoEFFN`` (8 -> 16 hidden, 4 experts, top-2) between two ``Dense``
  in ``make_train_step`` on dp=2 x ep=2 with
  ``param_shardings=expert_shardings("ep")`` (each rank holds 2
  experts), 4 steps at lr 0.1, against the reference's step on the same
  mesh: losses within rtol 1e-5, parameters within rtol 1e-4 / atol
  1e-6;
- the reference's ``test_dp_tp_train_step_grads_match_single`` net on
  dp=2 x tp=2 (the second ``Dense``'s weight ``P("tp", None)``), 3 steps
  at lr 0.1: losses within rtol 1e-5 and parameters within rtol 1e-5 /
  atol 1e-6 of the reference's;
- the replicas: every rank's losses, and the parameters it gathers,
  equal bit for bit; the MoE step's checkpoint (expert leaves as
  per-rank blocks) restores bit for bit at dp=2 x ep=2 and is refused
  at dp=1 x ep=4.
"""
import glob
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
from incubator_mxnet_tpu.gluon.contrib.nn import MoEFFN as JMoEFFN
from incubator_mxnet_tpu.parallel import P as JP
from incubator_mxnet_tpu.parallel import make_mesh as jmesh
from incubator_mxnet_tpu.parallel import make_train_step as jmake
from incubator_mxnet_tpu.parallel import moe as jmoe

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert, tracing
from incubator_mxnet_tpu_torch.parallel import Mesh, make_train_step
from incubator_mxnet_tpu_torch.parallel import moe as tmoe

import torch_dist_launch
import torch_mp_worker

RANKS = 4
CPU = torch.device("cpu")
ARGS = torch_mp_worker.MOE_ARGS


def _ffn_inputs(T, D, E, H, seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.normal(size=(T, D)).astype(np.float32),
            "gate_w": rng.normal(size=(D, E)).astype(np.float32),
            "w1": rng.normal(0, 0.3, (E, D, H)).astype(np.float32),
            "b1": rng.normal(0, 0.1, (E, H)).astype(np.float32),
            "w2": rng.normal(0, 0.3, (E, H, D)).astype(np.float32),
            "b2": rng.normal(0, 0.1, (E, D)).astype(np.float32),
            "cot": rng.normal(size=(T, D)).astype(np.float32)}


def _jax_ffn(arrs, fn, **kw):
    """``fn``'s output, aux and the gradients of ``sum(out * cot) +
    aux`` with respect to its six arguments."""
    args = [jnp.asarray(arrs[a]) for a in ARGS]
    cot = jnp.asarray(arrs["cot"])

    def f(*a):
        out, aux = fn(*a, return_aux=True, **kw)
        return jnp.sum(out * cot) + aux, (out, aux)

    grads, (out, aux) = jax.grad(f, argnums=tuple(range(6)),
                                 has_aux=True)(*args)
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


def _torch_ffn(arrs, **kw):
    args = [torch.from_numpy(arrs[a]).requires_grad_() for a in ARGS]
    out, aux = tmoe.moe_ffn(*args, return_aux=True, **kw)
    ((out * torch.from_numpy(arrs["cot"])).sum() + aux).backward()
    return (out.detach().numpy(), float(aux.detach()),
            [a.grad.numpy() for a in args])


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [None, 100.0, 0.5])
def test_moe_ffn_matches_reference(top_k, capacity_factor):
    arrs = _ffn_inputs(32, 8, 4, 12, seed=top_k)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    out, aux, grads = _torch_ffn(arrs, **kw)
    want, want_aux, want_grads = _jax_ffn(arrs, jmoe.moe_ffn, **kw)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    for a, g, w in zip(ARGS, grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=a)
    assert aux >= 1.0 - 1e-5


def test_capacity_counts_exact_in_bf16():
    """All 600 decisions go to expert 0 (positive features, gate column 0
    at 5): capacity 150 keeps exactly the first 150 tokens, as the
    reference does."""
    rng = np.random.RandomState(0)
    T, D, E, H = 600, 8, 2, 12
    x = (np.abs(rng.normal(size=(T, D))) + 0.1).astype(np.float32)
    gate = np.zeros((D, E), np.float32)
    gate[:, 0] = 5.0
    w1 = rng.normal(0, 0.3, (E, D, H)).astype(np.float32)
    w2 = rng.normal(0, 0.3, (E, H, D)).astype(np.float32)
    b1, b2 = np.zeros((E, H), np.float32), np.zeros((E, D), np.float32)
    arrays = (x, gate, w1, b1, w2, b2)
    y = tmoe.moe_ffn(*(torch.from_numpy(a).bfloat16() for a in arrays),
                     top_k=1, capacity_factor=0.5)
    kept = np.any(y.float().numpy() != 0.0, axis=-1)
    want = jmoe.moe_ffn(*(jnp.asarray(a).astype(jnp.bfloat16)
                          for a in arrays), top_k=1, capacity_factor=0.5)
    assert kept.sum() == 150
    np.testing.assert_array_equal(
        kept, np.any(np.asarray(want.astype(jnp.float32)) != 0.0, axis=-1))


def test_router_ties_go_to_the_lower_expert():
    """Tied router probabilities: ``jax.lax.top_k`` returns the lower
    expert first, and so does the port (a uniform router; experts 1 and
    3 tied above the others)."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    probs = [np.full((16, 4), 0.25, np.float32),
             np.tile(np.array([0.1, 0.35, 0.2, 0.35], np.float32), (16, 1))]
    for p, k in ((probs[0], 2), (probs[1], 1), (probs[1], 3)):
        _, got = tmoe._top_k(torch.from_numpy(p), k)
        _, want = jax.lax.top_k(jnp.asarray(p), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # through the whole layer: a zero gate ties every expert
    arrs = _ffn_inputs(16, 8, 4, 12, seed=7)
    arrs["x"] = x
    arrs["gate_w"] = np.zeros((8, 4), np.float32)
    out, aux, _ = _torch_ffn(arrs, top_k=2, capacity_factor=2.0)
    want, want_aux, _ = _jax_ffn(arrs, jmoe.moe_ffn, top_k=2,
                                 capacity_factor=2.0)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def test_load_balancing_loss_matches_reference():
    rng = np.random.RandomState(3)
    logits = rng.normal(size=(64, 4)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(logits), -1)
    _, idx = tmoe._top_k(probs, 2)
    want = jmoe.load_balancing_loss(jax.nn.softmax(jnp.asarray(logits), -1),
                                    jnp.asarray(idx.numpy()))
    np.testing.assert_allclose(float(tmoe.load_balancing_loss(probs, idx)),
                               float(want), rtol=1e-6)


def test_moe_ffn_sharded_refusals():
    mesh = Mesh(("ep",), [2], [CPU, CPU], [None])
    arrs = _ffn_inputs(8, 4, 4, 6, seed=0)
    args = [torch.from_numpy(arrs[a]) for a in ARGS]
    with pytest.raises(ValueError, match="'tp' is not one of the mesh"):
        tmoe.moe_ffn_sharded(*args, mesh, axis_name="tp")
    bad = list(args)
    bad[2] = args[2][0]
    with pytest.raises(ValueError, match=r"moe_ffn_sharded\(w1\)"):
        tmoe.moe_ffn_sharded(*bad, mesh)
    odd = _ffn_inputs(8, 4, 3, 6, seed=0)
    with pytest.raises(ValueError, match="3 experts do not divide"):
        tmoe.moe_ffn_sharded(*(torch.from_numpy(odd[a]) for a in ARGS),
                             mesh)


def test_aux_loss_must_be_a_scalar():
    tc = tracing.TraceContext(training=True)
    with pytest.raises(ValueError, match="must be a scalar"):
        tc.add_aux_loss(torch.ones(2), source="MoEFFN(x)")
    tc.add_aux_loss(torch.ones(()))
    assert len(tc.aux_losses) == 1


def _jax_moe_net():
    """The reference's ``test_moe_gluon_ep_train`` net."""
    jmx.random.seed(9)
    net = jnn.HybridSequential()
    moe = JMoEFFN(16, 4, top_k=2, capacity_factor=2.0, aux_loss_weight=1e-2)
    net.add(jnn.Dense(8, activation="relu"), moe, jnn.Dense(4))
    net.initialize(init=jmx.init.Xavier())
    net(nd.ones((2, 8)))
    return net


def _moe_batch():
    rng = np.random.RandomState(2)
    return (rng.rand(16, 8).astype(np.float32),
            (np.arange(16) % 4).astype(np.float32))


def _values(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def test_moe_block_one_process_step_matches_reference():
    """``MoEFFN`` in the plain step: its load-balancing loss joins the
    objective through the trace context, as in the reference."""
    jnet = _jax_moe_net()
    inputs = {"one.w%d" % i: w for i, w in enumerate(_values(jnet))}
    x, y = _moe_batch()
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    jstep = jmake(jnet, loss_fn, optimizer="sgd", learning_rate=0.1,
                  lint="off")
    want = [float(jstep(nd.array(x), nd.array(y)).asscalar())
            for _ in range(3)]
    net = torch_mp_worker.moe_net(inputs, "one")
    step = make_train_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer="sgd", learning_rate=0.1, device="cpu")
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(convert.params_to_numpy(net), _values(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the 4-rank job
# ---------------------------------------------------------------------------

def _jax_tp_net():
    jmx.random.seed(11)
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(4))
    net.initialize(init=jmx.init.Xavier())
    net(nd.ones((2, 8)))
    return net


def _tp_batch():
    return (np.random.RandomState(0).rand(16, 8).astype(np.float32),
            (np.arange(16) % 4).astype(np.float32))


def _reference(arrs):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    ref = {"ffn": _jax_ffn(arrs, lambda *a, **kw: jmoe.moe_ffn_sharded(
        *a, jmesh({"ep": 2}, devices=jax.devices()[:2]), **kw),
        top_k=2, capacity_factor=2.0)}
    net = _jax_moe_net()
    moe = net[1]
    step = jmake(net, loss_fn, optimizer="sgd", learning_rate=0.1,
                 mesh=jmesh({"dp": 2, "ep": 2}, devices=jax.devices()[:4]),
                 param_shardings=moe.expert_shardings("ep"), lint="off")
    x, y = _moe_batch()
    ref["moe"] = ([float(step(nd.array(x), nd.array(y)).asscalar())
                   for _ in range(4)], _values(net))
    net = _jax_tp_net()
    step = jmake(net, loss_fn, optimizer="sgd", learning_rate=0.1,
                 mesh=jmesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4]),
                 param_shardings={net[1].weight.name: JP("tp", None)},
                 lint="off")
    x, y = _tp_batch()
    ref["tp"] = ([float(step(nd.array(x), nd.array(y)).asscalar())
                  for _ in range(3)], _values(net))
    return ref


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("moe")
    arrs = _ffn_inputs(16, 8, 4, 12, seed=1)
    inputs = {"ffn." + k: v for k, v in arrs.items()}
    for i, w in enumerate(_values(_jax_moe_net())):
        inputs["moe.w%d" % i] = w
    inputs["moe.x"], inputs["moe.y"] = _moe_batch()
    for i, w in enumerate(_values(_jax_tp_net())):
        inputs["tp.w%d" % i] = w
    inputs["tp.x"], inputs["tp.y"] = _tp_batch()
    np.savez(os.path.join(str(outdir), "inputs.npz"), **inputs)
    proc = torch_dist_launch.start("moe", outdir, ranks=RANKS,
                                   worker=torch_dist_launch.MP_WORKER)
    try:
        ref = _reference(arrs)
    except BaseException:
        proc.kill()
        raise
    return torch_dist_launch.finish(proc, outdir, ranks=RANKS), ref, outdir


def test_moe_ffn_sharded_matches_reference(job):
    ranks, ref = job[0], job[1]
    out, aux, grads = ref["ffn"]
    for r in ranks:
        np.testing.assert_allclose(r["ffn.out"], out, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r["ffn.aux"]), aux, rtol=1e-5)
        for a, g in zip(ARGS, grads):
            np.testing.assert_allclose(r["ffn.d" + a], g, rtol=1e-4,
                                       atol=1e-5, err_msg=a)
    # one all_reduce of the combine forward, one of x's gradient back;
    # the combine's columns all-gathered back, and the four experts'
    assert json.loads(str(ranks[0]["ffn.calls"])) == \
        {"all_gather": 5, "all_reduce": 2}


@pytest.mark.parametrize("case,steps", [("moe", 4), ("tp", 3)])
def test_sharded_step_matches_reference(job, case, steps):
    ranks, ref = job[0], job[1]
    losses, params = ref[case]
    r0 = ranks[0]
    np.testing.assert_allclose(r0[case + ".loss"], losses, rtol=1e-5)
    for i, want in enumerate(params):
        np.testing.assert_allclose(
            r0["%s.p%d" % (case, i)], want, err_msg="param %d" % i,
            **(dict(rtol=1e-4, atol=1e-6) if case == "moe"
               else dict(rtol=1e-5, atol=1e-6)))
    for r in ranks[1:]:
        for k in r0:
            if k.startswith(case + ".") and not k.endswith(".calls"):
                assert r[k].tobytes() == r0[k].tobytes(), k
    assert len(r0[case + ".loss"]) == steps


def test_each_rank_holds_its_shard(job):
    for r in job[0]:
        assert int(r["moe.expert_rows"]) == 2 and int(r["tp.rows"]) == 2


def test_sharded_step_collectives(job):
    """The MoE step a step: the capacity's count all_gather and the
    combine's all_reduce over ep, the aux loss's count all_reduce over
    dp, the combine columns' all_gather and x's gradient all_reduce in
    the backward, the dp all_reduce; the batch check once.  The tp step:
    the weight's all_gather, the dp all_reduce."""
    r0 = job[0][0]
    assert json.loads(str(r0["moe.calls"])) == \
        {"all_gather": 1 + 2 * 4, "all_reduce": 4 * 4}
    assert json.loads(str(r0["tp.calls"])) == \
        {"all_gather": 1 + 3, "all_reduce": 3}


def test_checkpoint_of_expert_shards(job):
    ranks, outdir = job[0], job[2]
    for r in ranks:
        assert int(r["ckpt.restored"]) == 4 and bool(r["ckpt.same"])
        msg = str(r["ckpt.refusal"])
        assert msg.startswith("CheckpointTopologyError") and \
            "mesh axis 'ep' width 2 != 4" in msg, msg
    (path,) = glob.glob(os.path.join(str(outdir), "ckpt_moe", "*",
                                     "manifest.json"))
    with open(path) as f:
        arrays = json.load(f)["arrays"]
    sharded = [a for a in arrays if a["spec"] == "PartitionSpec('ep',)"]
    # the four expert parameters and their momenta: two blocks each
    assert len(sharded) == 8
    assert all(len(a["files"]) == 2 for a in sharded)
