"""The port's train->serve flywheel (``incubator_mxnet_tpu_torch/serve/
flywheel.py``, ``tools/flywheel_torch.py``) on the CPU: the reference's
five cases of ``tests/test_flywheel.py`` run on the port, and its pieces
against the reference's.

- The watch contract: ``latest_committed``/``watch`` blind to a
  mid-commit stage and to a torn step directory, prompt for a real
  commit.
- The gauntlet end to end: train, commit, promote, serve; a diverged
  candidate quarantined at the metric stage (``rollback_count`` stays
  0); a checksum-corrupted one at the load stage; the ledger in order.
- The loss bomb: the supervisor rolls back, only clean steps commit, and
  every promoted version comes from a clean step.
- The swap storm under Poisson traffic: no hung future, exactly one
  version a row, no capture after warmup, the poison rejected with the
  incumbent bitwise unchanged.
- The CLI soak at the tool's defaults, clean and both chaos legs: exit 0
  and a coherent JSON record (the reference marks it ``slow``; at the
  port's size it runs in seconds).
- ``held_out_ce`` equal to the reference's on the same logits, and
  ``read_promotions`` of a ledger with a torn tail equal to the
  reference's reading.

Every wait is bounded and every batcher closed in ``finally``.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.serve import flywheel as jfly

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, gluon
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.io import NDArrayIter, ResilientIter
from incubator_mxnet_tpu_torch.parallel import (CheckpointManager,
                                                SupervisorConfig,
                                                make_train_step,
                                                run_supervised)
from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
from incubator_mxnet_tpu_torch.parallel.supervisor import HealthLedger
from incubator_mxnet_tpu_torch.serve import (ContinuousBatcher,
                                             PromotionDaemon, ServeEngine,
                                             held_out_ce,
                                             load_candidate_params,
                                             poisson_loadtest,
                                             read_promotions)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


def _net(seed=0):
    tmx.random.seed(seed)
    with context.device_scope("cpu"):
        net = nn.HybridSequential()
        for _ in range(2):
            net.add(nn.Dense(16, activation="tanh"))
        net.add(nn.Dense(13))
    net.initialize(init=tmx.init.Xavier())
    net.shape_init((2, 16))
    return net


def _job(root, seed=0):
    net = _net(seed)
    step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer="adam", learning_rate=0.01,
                           device="cpu")
    rng = np.random.RandomState(5)
    X = rng.rand(64, 16).astype(np.float32)
    Y = rng.randint(0, 4, 64).astype(np.float32)
    np.random.seed(3)
    it = ResilientIter(NDArrayIter(X, Y, batch_size=8, shuffle=True,
                                   ctx=CPU))
    return step, it, CheckpointManager(os.path.join(root, "ckpt")), (X, Y)


def _engine(seed=0):
    eng = ServeEngine(_net(seed), buckets=(8, 16), device="cpu")
    eng.warmup(np.zeros((16,), np.float32))
    return eng


# ---------------------------------------------------------------------------
# the watch contract: committed steps only
# ---------------------------------------------------------------------------

def test_latest_committed_never_returns_mid_commit_stage(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_committed() is None
    assert mgr.watch(timeout=0.2) is None
    mgr.save(2, {"params": [np.arange(4, dtype=np.float32)]})
    assert mgr.latest_committed() == 2
    # a newer stage directory, as a crashed mid-commit save leaves it
    stage = os.path.join(mgr.directory, ".tmp-step-%08d" % 4)
    os.makedirs(stage)
    with open(os.path.join(stage, "arr_00000.bin"), "wb") as f:
        f.write(b"x" * 16)
    # a newer committed-looking directory with no manifest
    torn = os.path.join(mgr.directory, "step-%08d" % 6)
    os.makedirs(torn)
    assert mgr.latest_committed() == 2
    assert mgr.watch(after=2, timeout=0.2) is None

    def committer():
        time.sleep(0.1)
        mgr.save(8, {"params": [np.arange(4, dtype=np.float32)]})

    t = threading.Thread(target=committer)
    t.start()
    try:
        assert mgr.watch(after=2, timeout=10.0) == 8
    finally:
        t.join(timeout=10.0)


# ---------------------------------------------------------------------------
# the gauntlet
# ---------------------------------------------------------------------------

def test_promotion_gauntlet_promotes_then_quarantines(tmp_path):
    step, it, mgr, (X, Y) = _job(str(tmp_path))
    run_supervised(step, it, mgr, until_step=6,
                   config=SupervisorConfig(checkpoint_every=2))
    it.close()

    eng = _engine(seed=0)   # shared lineage: serving the training init
    daemon = PromotionDaemon(mgr, eng, held_out=(X[:16], Y[:16]),
                             metric_slack=0.5)
    rec = daemon.poll_once(timeout=2.0)
    assert rec is not None and rec["event"] == "promoted", rec
    assert rec["step"] == mgr.latest_committed()
    assert eng.params_version == rec["version"] > 1
    assert eng.recompile_count == 0
    assert torch.isfinite(eng.infer(X[:8])).all()
    assert daemon.poll_once(timeout=0.2) is None

    raw = load_candidate_params(mgr, mgr.latest_committed())
    assert [a.shape for a in raw] == [(16, 16), (16,), (16, 16), (16,),
                                      (13, 16), (13,)]
    # diverged (finite, off by four orders of magnitude): rejected by the
    # held-out metric before the swap path
    mgr.save(8, {"params": [np.asarray(a) * 1e4 for a in raw]})
    rec2 = daemon.poll_once(timeout=2.0)
    assert rec2["event"] == "quarantined" and rec2["stage"] == "metric"
    assert eng.rollback_count == 0
    assert eng.params_version == rec["version"]
    # corrupt: quarantined at the load stage (checksum)
    mgr.save(10, {"params": [np.asarray(a) for a in raw]})
    d = mgr._step_dir(10)
    man = json.load(open(os.path.join(d, "manifest.json")))
    pfile = [e for e in man["arrays"]
             if e["key"] == "['params'][0]"][0]["files"][0]["file"]
    with open(os.path.join(d, pfile), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    rec3 = daemon.poll_once(timeout=2.0)
    assert rec3["event"] == "quarantined" and rec3["stage"] == "load"

    events = read_promotions(daemon.ledger_path)
    assert [e["event"] for e in events] == \
        ["promoted", "quarantined", "quarantined"]
    assert daemon.promoted_count == 1 and daemon.quarantined_count == 2
    assert events[0]["verdicts"] == {"load": "ok", "metric": "ok",
                                     "swap": "ok"}


def test_loss_bomb_never_promotes_diverged_weights(tmp_path):
    step, it, mgr, (X, Y) = _job(str(tmp_path))
    with fi.loss_bomb(at=4, factor=1e4) as st:
        out = run_supervised(step, it, mgr, until_step=10,
                             config=SupervisorConfig(checkpoint_every=2))
    it.close()
    assert st.fired == 1 and out["rollbacks"] == 1
    assert all(s <= 4 or s >= 6 for s in mgr.steps())

    eng = _engine(seed=0)
    daemon = PromotionDaemon(mgr, eng, held_out=(X[:16], Y[:16]),
                             metric_slack=0.5)
    while daemon.poll_once(timeout=0.5) is not None:
        pass
    promoted = [e for e in read_promotions(daemon.ledger_path)
                if e["event"] == "promoted"]
    assert promoted, "a clean post-rollback checkpoint must promote"
    assert all(e["step"] in mgr.steps() for e in promoted)
    assert eng.rollback_count == 0 and eng.recompile_count == 0


def test_swap_storm_exactly_one_version_no_recompiles():
    eng = _engine(seed=0)
    batcher = ContinuousBatcher(eng, max_delay=0.005)
    pool = np.random.RandomState(0).rand(32, 16).astype(np.float32)
    try:
        with fi.swap_storm(eng, n_swaps=4, interval=0.02,
                           poison_at=2, seed=0) as st:
            rep = poisson_loadtest(batcher, lambda i, rng: pool[i % 32],
                                   qps=150.0, n_requests=60, seed=1)
    finally:
        batcher.close()
    assert st.error is None
    assert st.attempted == 4 and st.committed == 3
    assert st.poison_rejected and st.incumbent_bitwise_ok
    assert eng.rollback_count == 1
    assert rep.hung == 0 and rep.unattributed == 0
    assert rep.ok > 0 and sum(rep.versions.values()) == rep.ok
    assert rep.recompiles == 0
    assert rep.promotions == 3 and rep.rollbacks == 1


@pytest.mark.parametrize("chaos", [None, "loss_bomb", "swap_storm"])
def test_flywheel_cli_soak(tmp_path, chaos):
    cmd = [sys.executable, os.path.join(ROOT, "tools", "flywheel_torch.py"),
           "--device", "cpu", "--dir", str(tmp_path / "run")]
    if chaos:
        cmd += ["--chaos", chaos]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["failures"] == [] and rec["device"] == "cpu"
    assert rec["recompiles"] == 0 and rec["trained_steps"] == 10
    if chaos == "loss_bomb":
        assert rec["train_rollbacks"] == 1
        assert rec["serving_rollbacks"] == 0
        assert rec["quarantined"] and rec["quarantined"][0][1] == "metric"
    else:
        assert rec["promoted"]
    if chaos == "swap_storm":
        storm = rec["swap_storm"]
        assert storm["committed"] > 0 and storm["unattributed"] == 0
        assert storm["p99_ms"] <= storm["bound_ms"]


# ---------------------------------------------------------------------------
# the pieces against the reference's
# ---------------------------------------------------------------------------

def test_held_out_ce_matches_reference():
    rs = np.random.RandomState(12)
    logits = (rs.randn(9, 13) * 5).astype(np.float32)
    labels = rs.randint(0, 13, 9).astype(np.float32)
    want = jfly.held_out_ce(logits, labels)
    assert held_out_ce(torch.from_numpy(logits), labels) == want
    assert held_out_ce((torch.from_numpy(logits),), labels) == want
    bad = logits.copy()
    bad[3, 2] = np.inf
    assert held_out_ce(torch.from_numpy(bad), labels) == float("inf") == \
        jfly.held_out_ce(bad, labels)
    with pytest.raises(ValueError, match="do not match"):
        held_out_ce(torch.from_numpy(logits), labels[:4])


def test_read_promotions_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "promotions.jsonl")
    led = HealthLedger(path)
    led.append("promoted", step=2, version=2, from_version=1,
               verdicts={"load": "ok", "metric": "ok", "swap": "ok"})
    led.append("quarantined", step=4, stage="metric", reason="worse",
               verdicts={"load": "ok", "metric": "fail"},
               incumbent_version=2)
    with open(path, "a") as f:
        f.write('{"event": "promoted", "seq": 3, "st')   # killed mid-append
    got = read_promotions(path)
    assert got == jfly.read_promotions(path)
    assert [e["event"] for e in got] == ["promoted", "quarantined"]
    # the next writer seals the torn line first
    HealthLedger(path).append("promoted", step=6, version=3,
                              from_version=2, verdicts={})
    assert [e.get("step") for e in read_promotions(path)] == [2, 4, 6]
    assert read_promotions(str(tmp_path / "absent.jsonl")) == []
