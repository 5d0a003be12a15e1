"""Elastic multi-process training in the port against the JAX package's
(``tests/test_elastic.py``), on the CPU: checkpoints of a ``TrainStep``
whose mesh spans processes, restored at another width.

Two gloo jobs of 2 ranks (``tests/torch_dist_launch.py``, modes of
``tests/torch_dist_worker.py``, which imports no JAX) and this process
run the reference worker's net: two ``Dense(16, tanh)`` and a ragged
``Dense(13)`` head (13 rows pad to 14 at dp=2, 16 at dp=8), adam at lr
1e-3, ``zero=1``, a dynamic loss scale, fed a shuffled
``ResilientIter(NDArrayIter)`` of global batches of 8, each rank on its
rows; the nets start from the JAX net's weights.

- The matrix (``test_elastic.py:119``): save at dp=2 after step 3,
  restore at dp=1 here, re-save at dp=1 before stepping, restore that at
  dp=2.  The logical state (params, PRNG key, step, loss scale, the
  optimizer state without its padding) is bit-identical at every hop;
  the batches continue the saved epoch exactly; dp=1's losses are within
  2e-6 of dp=2's (a different sum order), the round trip's equal bit for
  bit.  Each rank wrote only its own ZeRO-1 shards.
- A ``zero`` change (``:188``): the dp=2 ``zero=1`` checkpoint restores
  into a ``zero=0`` step, whose checkpoint restores at dp=2 ``zero=1``.
  Refusals (``:273``, ``:294``): another batch size, another head.
- A corrupt shard file of the newest step that only rank 1 reads sends
  both ranks back to the previous step.
- Kill and rejoin (``:523``): in the step-4 save rank 1 dies
  (``host_loss_during_save``); rank 0 refuses the commit naming the
  done-marker, the torn stage stays invisible, and a one-process resume
  here restores step 2 and replays the two lost batches.
- Across packages: the JAX step at dp=2 and dp=8 (of the conftest's 8
  CPU devices) writes checkpoints the two ranks restore to the same
  logical state bit for bit; the ranks' checkpoint restores into the JAX
  step at dp=2 and dp=8 bit for bit, with the iterator, and the two
  steps after it stay within 1e-4 of the ranks'.
- ``coordinator_unreachable`` makes ``distributed.initialize`` raise
  naming the coordinator and the rank.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.io import NDArrayIter as JIter
from incubator_mxnet_tpu.io import ResilientIter as JResilient
from incubator_mxnet_tpu.parallel import make_mesh as jmesh
from incubator_mxnet_tpu.parallel import make_train_step as jmake

from incubator_mxnet_tpu_torch.parallel import checkpoint as tck
from incubator_mxnet_tpu_torch.parallel import distributed as tdist
from incubator_mxnet_tpu_torch.parallel import fault_injection as tfi
from incubator_mxnet_tpu_torch.parallel import make_mesh

import torch_dist_launch
import torch_dist_worker as W

CPU = torch.device("cpu")
N_W = 6  # weights and biases of the three layers
CROSS_WIDTH_ATOL = 2e-6
CROSS_PACKAGE_ATOL = 1e-4

pytestmark = pytest.mark.filterwarnings("ignore:.*GL009")


# -- the JAX side --------------------------------------------------------------

def _jax_net(seed=0):
    jmx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, in_units=W.ELASTIC_FEAT, activation="tanh"),
            jnn.Dense(16, in_units=16, activation="tanh"),
            jnn.Dense(13, in_units=16))
    net.initialize(init=jmx.init.Xavier())
    return net


def _jax_step(dp, seed=0):
    mesh = jmesh({"dp": dp}, devices=jax.devices()[:dp])
    return jmake(_jax_net(seed), jgluon.loss.SoftmaxCrossEntropyLoss(),
                 optimizer="adam", learning_rate=1e-3, mesh=mesh, zero=1,
                 nonfinite="skip", loss_scale="dynamic", lint="off")


def _jax_iter(shuffle_seed):
    X, Y = W.elastic_data()
    np.random.seed(shuffle_seed)
    return JResilient(JIter(X, Y, batch_size=W.ELASTIC_BATCH, shuffle=True))


def _jax_logical(step):
    """The logical state of a JAX step, as :func:`_logical` gives it."""
    pad0 = step._zero_pad0 or [None] * len(step._gp)
    opt = []
    for leaves, p, pad in zip(step._opt_state, step._gp, pad0):
        for leaf in (leaves if isinstance(leaves, tuple) else (leaves,)):
            a = np.asarray(leaf)
            opt.append(a[:p.shape[0]] if pad is not None else a)
    return {"params": [np.asarray(p._data._data) for p in step._gp],
            "aux": [np.asarray(p._data._data) for p in step._aux],
            "rng": np.asarray(step._key_dev).astype(np.uint32),
            "step": int(step.step_count),
            "scale": [np.asarray(v) for v in step._scaler_dev], "opt": opt}


# -- the port side -------------------------------------------------------------

def _logical(ranks, prefix):
    """The global logical state from each rank's ``logical_parts`` (a
    dict of one process, or the list of ranks' dicts): the optimizer
    rows of the ranks joined in rank order."""
    ranks = ranks if isinstance(ranks, list) else [ranks]
    r0 = ranks[0]

    def seq(tag):
        out, i = [], 0
        while "%s%s%d" % (prefix, tag, i) in r0:
            out.append(r0["%s%s%d" % (prefix, tag, i)])
            i += 1
        return out

    opt = [np.concatenate([r["%so%d" % (prefix, i)] for r in ranks])
           for i in range(len(seq("o")))]
    for r in ranks[1:]:
        for tag in ("p", "a", "s"):
            for i, a in enumerate(seq(tag)):
                assert r["%s%s%d" % (prefix, tag, i)].tobytes() == \
                    a.tobytes(), "replicas differ"
    return {"params": seq("p"), "aux": seq("a"),
            "rng": np.asarray(r0[prefix + "rng"]).astype(np.uint32),
            "step": int(r0[prefix + "step"]), "scale": seq("s"), "opt": opt}


def _assert_state_equal(a, b):
    for k in ("params", "aux", "opt", "scale"):
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k
    assert a["rng"].tobytes() == b["rng"].tobytes()
    assert a["step"] == b["step"]


def _one_process(weights=None, seed=0, zero=1, head=13):
    """A port step here at dp=1 (a mesh of this process, no group)."""
    mesh = make_mesh({"dp": 1}, devices=[CPU])
    return W.elastic_step(W.elastic_net(CPU, weights, seed, head), CPU,
                          mesh, zero=zero), mesh


def _drive(step, mesh, it, n):
    idx, losses = [], []
    for _ in range(n):
        b = it.next()
        idx.append(np.asarray(b.index).copy())
        losses.append(W.elastic_feed(step, mesh, b, CPU))
    return np.stack(idx), np.asarray(losses)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both jobs, the work of this process between and beside them, and
    the one-process resume after the kill."""
    outdir = str(tmp_path_factory.mktemp("elastic"))
    path = lambda name: os.path.join(outdir, name)  # noqa: E731
    weights = [p.data().asnumpy() for p in
               _jax_net().collect_params().values()]
    assert len(weights) == N_W
    np.savez(path("inputs.npz"),
             **{"el.w%d" % i: w for i, w in enumerate(weights)})
    got = {}

    # job 1: the dp=2 run, then the JAX checkpoints written meanwhile
    proc = torch_dist_launch.start("elastic_save", outdir)
    try:
        X, Y = W.elastic_data()
        for dp in (2, 8):
            js = _jax_step(dp)
            for s in range(2):
                js(nd.array(X[8 * s:8 * s + 8], dtype="float32"),
                   nd.array(Y[8 * s:8 * s + 8], dtype="float32"))
            js.save_checkpoint(path("jax_dp%d" % dp))
            got["jax_dp%d" % dp] = _jax_logical(js)
        with open(path("jax_ready"), "w") as f:
            f.write("jax_dp2 jax_dp8")
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    got["a"] = torch_dist_launch.finish(proc, outdir)

    # here, at dp=1: the matrix's elastic restore, re-saved before
    # stepping; the zero=0 run and its checkpoint
    step, mesh = _one_process(seed=17)
    it = W.elastic_iter(12)
    got["one.restored"] = step.restore_checkpoint(path("ckpt_dp2"),
                                                  data_iter=it)
    got["one.state"] = _logical(W.logical_parts(step, ""), "")
    step.save_checkpoint(path("ckpt_dp1"), data_iter=it)
    got["one.idx"], got["one.loss"] = _drive(step, mesh, it, 3)
    it.close()
    step, mesh = _one_process(seed=19, zero=0)
    it = W.elastic_iter(12)
    got["zero0.restored"] = step.restore_checkpoint(path("ckpt_dp2"),
                                                    data_iter=it)
    got["zero0.state"] = _logical(W.logical_parts(step, ""), "")
    step.save_checkpoint(path("ckpt_zero0"), data_iter=it)
    it.close()

    # job 2: the round trip and the zero change at dp=2, then the kill;
    # meanwhile the ranks' checkpoint restores into the JAX step
    proc = torch_dist_launch.start("elastic_restore", outdir)
    try:
        for dp in (2, 8):
            js = _jax_step(dp, seed=31)
            jit = _jax_iter(14)
            got["jx%d.restored" % dp] = js.restore_checkpoint(
                path("ckpt_dp2"), data_iter=jit)
            got["jx%d.state" % dp] = _jax_logical(js)
            idx, losses = [], []
            for _ in range(2):
                b = jit.next()
                idx.append(np.asarray(b.index).copy())
                losses.append(float(js(b.data[0], b.label[0]).asnumpy()))
            jit.close()
            got["jx%d.idx" % dp] = np.stack(idx)
            got["jx%d.loss" % dp] = np.asarray(losses)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    got["kill.rc"], got["kill.out"] = torch_dist_launch.wait(proc)
    got["b"] = torch_dist_launch.load(outdir)
    got["kill"] = []
    for r in range(2):
        with open(path("kill_rank%d.json" % r)) as f:
            got["kill"].append(json.load(f))
    got["kill.dir"] = sorted(os.listdir(path("kill_ckpt")))

    # the one-process rejoin after the kill
    step, mesh = _one_process(seed=9)
    it = W.elastic_iter(4)
    mgr = tck.CheckpointManager(path("kill_ckpt"))
    got["rejoin.restored"] = step.restore_checkpoint(mgr, data_iter=it)
    got["rejoin.steps"] = mgr.steps()
    got["rejoin.idx"], got["rejoin.loss"] = _drive(step, mesh, it, 2)
    got["rejoin.step_count"] = step.step_count
    it.close()
    got["dir"] = outdir
    return got


def test_elastic_resume_matrix_dp2_to_1_to_2(runs):
    a, b = runs["a"], runs["b"]
    saved = _logical(a, "a3.")
    assert saved["step"] == 3
    # dp=2 -> dp=1: the state, and the batches of the saved epoch
    assert runs["one.restored"] == 3
    _assert_state_equal(runs["one.state"], saved)
    np.testing.assert_array_equal(runs["one.idx"], a[0]["a.idx"][3:])
    np.testing.assert_allclose(runs["one.loss"], a[0]["a.loss"][3:], rtol=0,
                               atol=CROSS_WIDTH_ATOL)
    # dp=1 -> dp=2: the same state again, and the run's own losses
    assert int(b[0]["b.restored"]) == 3
    _assert_state_equal(_logical(b, "b3."), saved)
    for r in (0, 1):
        np.testing.assert_array_equal(b[r]["b.idx"], a[r]["a.idx"][3:])
        assert b[r]["b.loss"].tobytes() == a[r]["a.loss"][3:].tobytes()
    assert a[0]["a.loss"].tobytes() == a[1]["a.loss"].tobytes()


def test_each_rank_writes_its_own_shards(runs):
    d = os.path.join(runs["dir"], "ckpt_dp2", "step-00000003")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    markers = []
    for r in (0, 1):
        with open(os.path.join(d, "done-p%05d.json" % r)) as f:
            markers.append(json.load(f))
    assert set(manifest["meta"]["data_iter_parts"]) == {"0", "1"}
    assert manifest["meta"]["topology"] == {
        "mesh": {"dp": 2}, "batch_axis": "dp", "zero": 1,
        "pipeline_stages": None, "processes": 2}
    sharded = [e for e in manifest["arrays"]
               if e["key"].startswith("['opt_state']")]
    assert len(sharded) == 2 * 3 * 2  # (mean, var) of 6 tensors
    for e in sharded:
        assert [f["file"].split(".", 1)[1] for f in e["files"]] == \
            ["shard000.bin", "shard001.bin"]
        rows = e["shape"][0] // 2
        assert [f["index"][0] for f in e["files"]] == [[0, rows],
                                                       [rows, 2 * rows]]
    mine = [sorted(f["file"] for files in m["files"].values()
                   for _, f in files) for m in markers]
    assert all(".shard001." in n for n in mine[1])
    assert not any(".shard001." in n for n in mine[0])
    assert len(mine[0]) + len(mine[1]) == sum(len(e["files"])
                                              for e in manifest["arrays"])


def test_elastic_restore_across_zero_mode_change(runs):
    saved = _logical(runs["a"], "a3.")
    assert runs["zero0.restored"] == 3
    _assert_state_equal(runs["zero0.state"], saved)
    b = runs["b"]
    assert int(b[0]["z.restored"]) == 3
    _assert_state_equal(_logical(b, "z."), saved)
    assert np.isfinite(b[0]["z.loss"])


def test_corrupt_peer_shard_walks_every_rank_back(runs):
    """Rank 1's shard of step 4 is corrupt; rank 0 never reads it, yet
    both ranks restore step 3 (they agree on the step), and both refuse
    step 4 asked for by name."""
    b = runs["b"]
    assert tck.CheckpointManager(
        os.path.join(runs["dir"], "ckpt_walk")).steps() == [3, 4]
    for r in (0, 1):
        assert int(b[r]["w.restored"]) == 3
        assert bool(b[r]["w.warned"])
        assert str(b[r]["w.pinned"]) == "CheckpointCorruptError"
    _assert_state_equal(_logical(b, "w."), _logical(runs["a"], "a3."))


def test_restore_refusals_name_both_topologies(runs):
    d = os.path.join(runs["dir"], "ckpt_dp2")
    step, _ = _one_process(seed=5)
    smaller = W.elastic_iter(12, batch_size=4)
    with pytest.raises(tck.CheckpointTopologyError) as ei:
        step.restore_checkpoint(d, data_iter=smaller)
    smaller.close()
    msg = str(ei.value)
    assert "batch_size" in msg and "topology" in msg, msg
    other, _ = _one_process(head=5)
    with pytest.raises(tck.CheckpointTopologyError) as ei:
        other.restore_checkpoint(d)
    assert "saved topology" in str(ei.value)


def test_kill_and_rejoin_2_to_1_processes(runs):
    rank0, rank1 = runs["kill"]
    assert runs["kill.rc"] != 0, runs["kill.out"][-3000:]
    assert rank0["losses"] == rank1["losses"] and len(rank0["losses"]) == 4
    assert rank0.get("error") == "CheckpointError", rank0
    assert "done-marker" in rank0["message"] and "[1]" in rank0["message"]
    assert "error" not in rank1  # it died in the save
    assert rank0["steps"] == [2]
    assert "step-00000002" in runs["kill.dir"]
    assert ".tmp-step-00000004" in runs["kill.dir"]
    assert "step-00000004" not in runs["kill.dir"]
    # the refusal came within the commit timeout of the kill
    assert 0 < rank0["error_t"] - rank1["kill_t"] < 15
    assert runs["rejoin.restored"] == 2 and runs["rejoin.steps"] == [2]
    assert runs["rejoin.step_count"] == 4
    np.testing.assert_array_equal(runs["rejoin.idx"],
                                  np.asarray(rank0["idx"][2:4]))
    np.testing.assert_allclose(runs["rejoin.loss"], rank0["losses"][2:4],
                               rtol=0, atol=CROSS_WIDTH_ATOL)


@pytest.mark.parametrize("dp", [2, 8])
def test_jax_checkpoint_restores_in_port_ranks(runs, dp):
    a = runs["a"]
    name = "jax_dp%d" % dp
    assert int(a[0][name + ".restored"]) == 2
    _assert_state_equal(_logical(a, name + "."), runs[name])


@pytest.mark.parametrize("dp", [2, 8])
def test_port_checkpoint_restores_in_jax(runs, dp):
    a = runs["a"]
    assert runs["jx%d.restored" % dp] == 3
    _assert_state_equal(runs["jx%d.state" % dp], _logical(a, "a3."))
    np.testing.assert_array_equal(runs["jx%d.idx" % dp], a[0]["a.idx"][3:5])
    np.testing.assert_allclose(runs["jx%d.loss" % dp], a[0]["a.loss"][3:5],
                               rtol=0, atol=CROSS_PACKAGE_ATOL)


def test_coordinator_unreachable_names_rank_and_coordinator():
    with tfi.coordinator_unreachable():
        with pytest.raises(tdist.DistributedInitError) as ei:
            tdist.initialize(coordinator="10.0.0.9:9999", num_processes=2,
                             process_id=1, device="cpu")
    msg = str(ei.value)
    assert "process 1/2" in msg and "10.0.0.9:9999" in msg
    assert "injected" in str(ei.value.__cause__)
    assert not tdist.is_initialized()
