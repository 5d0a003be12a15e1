"""The port's run supervisor (``incubator_mxnet_tpu_torch/parallel/
supervisor.py``, ``tools/supervise_torch.py``, ``tools/launch_torch.py``)
against the JAX package's (``tests/test_supervisor.py``), on the CPU.

- The detectors (``StepClock``, ``hang_verdicts``, ``straggler_verdicts``,
  ``DivergenceDetector``) fed the same seeded timelines in both packages
  give equal verdicts, equal clock readings and equal ``suspicious``
  flags (pure Python on both sides: exactly equal).
- Heartbeat and ledger files written by one package are read by the
  other, field for field.
- The ladder (``Supervisor``) driven by the reference's scripted stub
  launchers leaves the same event sequence in both packages.
- ``run_supervised`` on ``build_worker_job``'s net (two ``Dense(16,
  tanh)``, ``Dense(13)``, adam at lr 0.01), the port's net given the JAX
  net's weights, under ``loss_bomb`` at call 4: the same rank-ledger
  events (divergence -> rollback -> recovered -> done, verdict
  ``loss_explosion``), the losses within ``LOSS_RTOL`` of the
  reference's (relative; the two packages round f32 differently, ~1e-7
  measured), and the port's replayed tail bit-identical to its own
  unfaulted run.
- ``tools/supervise_torch.py --cpu`` with ``kill_process`` at one rank:
  the respawned attempt's losses equal the in-process run's bit for bit.
- ``tools/launch.py`` and ``tools/launch_torch.py`` pass the cases of
  ``tests/test_launch.py``.
"""
import argparse
import json
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.io import NDArrayIter as JIter
from incubator_mxnet_tpu.io import ResilientIter as JResilient
from incubator_mxnet_tpu.parallel import CheckpointManager as JManager
from incubator_mxnet_tpu.parallel import make_train_step as jmake
from incubator_mxnet_tpu.parallel import fault_injection as jfi
from incubator_mxnet_tpu.parallel import supervisor as jsup

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.io import NDArrayIter as TIter
from incubator_mxnet_tpu_torch.io import ResilientIter as TResilient
from incubator_mxnet_tpu_torch.parallel import CheckpointManager as TManager
from incubator_mxnet_tpu_torch.parallel import make_train_step as tmake
from incubator_mxnet_tpu_torch.parallel import fault_injection as tfi
from incubator_mxnet_tpu_torch.parallel import supervisor as tsup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import launch  # noqa: E402
import launch_torch  # noqa: E402
import supervise_torch  # noqa: E402

CPU = torch.device("cpu")
#: run_supervised's losses, port against reference (relative)
LOSS_RTOL = 1e-5

pytestmark = pytest.mark.filterwarnings("ignore:.*GL0")


# ---------------------------------------------------------------------------
# detectors: the same seeded timelines through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_clock_parity(seed):
    rng = random.Random(seed)
    kw = dict(alpha=rng.choice([0.2, 0.3, 0.5]), factor=8.0,
              floor=rng.choice([0.5, 2.0]), startup_timeout=120.0)
    clocks = [jsup.StepClock(**kw), tsup.StepClock(**kw)]
    t = 100.0
    for _ in range(40):
        t += rng.expovariate(2.0)
        got = []
        for c in clocks:
            c.observe(t)
            got.append((c.ema, c.stall_timeout()))
        assert got[0] == got[1]
    with pytest.raises(ValueError):
        tsup.StepClock(alpha=0.0)


def _heartbeats(rng, n):
    return {r: {"rank": r, "step": rng.randint(0, 20),
                "status": rng.choice(["running", "running", "done",
                                      "failed", "diverged"]),
                "time": 100.0 - rng.uniform(0, 12)} for r in range(n)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hang_and_straggler_verdicts_parity(seed):
    rng = random.Random(seed)
    for _ in range(60):
        hbs = _heartbeats(rng, rng.randint(1, 6))
        timeout = rng.uniform(1, 10)
        last_seen = None if rng.random() < 0.5 else \
            {r: 100.0 - rng.uniform(0, 12) for r in hbs
             if rng.random() < 0.7}
        assert tsup.hang_verdicts(hbs, 100.0, timeout, last_seen) == \
            jsup.hang_verdicts(hbs, 100.0, timeout, last_seen)
        factor = rng.choice([1.2, 3.0])
        lag = rng.choice([1, 2, 4])
        assert tsup.straggler_verdicts(hbs, factor, lag) == \
            jsup.straggler_verdicts(hbs, factor, lag)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_divergence_detector_parity(seed):
    rng = random.Random(seed)
    kw = dict(skip_streak_budget=rng.choice([None, 2, 3]),
              explosion_factor=rng.choice([10.0, 1e3]),
              ema_alpha=rng.choice([0.2, 0.5]), patience=rng.choice([1, 2]),
              warmup=rng.choice([1, 3]), baseline_leak=0.01)
    dets = [jsup.DivergenceDetector(**kw), tsup.DivergenceDetector(**kw)]
    step = skipped = 0
    verdicts = 0
    for i in range(200):
        r = rng.random()
        if r < 0.15:
            skipped += 1
            loss = rng.choice([None, float("nan"), float("inf")])
        else:
            step += 1
            loss = rng.uniform(0.5, 2.0) * (1e4 if r > 0.9 else 1.0)
        got = [(d.update(step, loss, skipped), d.suspicious, d.skip_streak,
                d.ema) for d in dets]
        assert got[0] == got[1], i
        if got[0][0] is not None:
            verdicts += 1
            for d in dets:
                d.reset()
    assert verdicts > 0
    with pytest.raises(ValueError):
        tsup.DivergenceDetector(skip_streak_budget=0)
    with pytest.raises(ValueError):
        tsup.DivergenceDetector(explosion_factor=1.0)


def test_divergence_detector_cases():
    """The reference's two detector cases, in the port."""
    det = tsup.DivergenceDetector(skip_streak_budget=3)
    assert det.update(5, 1.0, skipped_steps=0) is None
    assert det.update(5, None, skipped_steps=1) is None
    assert det.update(5, None, skipped_steps=2) is None
    assert det.suspicious
    assert det.update(5, None, skipped_steps=3) == "skip_streak"
    det.reset()
    assert det.skip_streak == 0 and not det.suspicious
    det = tsup.DivergenceDetector(explosion_factor=1e3, ema_alpha=0.5,
                                  patience=2, warmup=2)
    for loss in (1.0, 1.1, 0.9):
        assert det.update(1, loss) is None
    assert det.update(2, 1e7) is None and det.suspicious
    assert det.update(3, 1e7) == "loss_explosion"


# ---------------------------------------------------------------------------
# heartbeat and ledger files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_heartbeats_and_ledger_cross_read(tmp_path, writer):
    w, r = (tsup, jsup) if writer == "port" else (jsup, tsup)
    d = str(tmp_path)
    em = w.HeartbeatEmitter(d, rank=3)
    em.emit(5, loss=1.25, loss_scale=2.0, skipped_steps=1)
    hb = em.emit(6, loss=1.0, loss_scale=2.0, skipped_steps=1,
                 status="done", extra_field=7)
    got = r.read_heartbeats(d)
    assert list(got) == [3] and got[3] == hb
    assert got[3]["seq"] == 2 and got[3]["extra_field"] == 7
    # a torn heartbeat and a .tmp twin stay invisible to both readers
    with open(os.path.join(d, "heartbeat-r00009.json"), "w") as f:
        f.write('{"rank": 9, "seq":')
    with open(os.path.join(d, "heartbeat-r00004.json.tmp"), "w") as f:
        f.write("{}")
    assert list(r.read_heartbeats(d)) == [3]
    led = w.HealthLedger(os.path.join(d, "health.jsonl"))
    led.append("launch", width=2, attempt=0)
    led.append("fault", verdict="hang", ranks=[1])
    w.HealthLedger(os.path.join(d, "health-r00001.jsonl")).append(
        "rollback", rank=1, to_step=4)
    with open(led.path, "a") as f:
        f.write('{"event": "torn')
    merged = r.read_ledger(d)
    assert [e["event"] for e in merged] == ["launch", "fault", "rollback"]
    assert merged[1]["ranks"] == [1] and merged[2]["to_step"] == 4
    # the reader's package appends past the torn line the writer left
    r.HealthLedger(led.path).append("resolved", width=2)
    assert [e["event"] for e in w.read_ledger(d)] == \
        ["launch", "fault", "rollback", "resolved"]
    os.makedirs(os.path.join(d, "step-00000002"))
    os.makedirs(os.path.join(d, ".tmp-step-00000004"))
    assert tsup.committed_steps(d) == jsup.committed_steps(d) == [2]


def test_heartbeat_write_failure_degrades_not_raises(tmp_path):
    """Heartbeats ride checkpoint._write_bytes: fail_writes reaches them,
    and a failed write warns without stopping the step."""
    em = tsup.HeartbeatEmitter(str(tmp_path), rank=0)
    with tfi.fail_writes(at=0, count=99):
        with pytest.warns(UserWarning, match="heartbeat write failed"):
            em.emit(1, loss=0.5)
    assert em.write_failures == 1
    assert tsup.read_heartbeats(str(tmp_path)) == {}
    em.emit(2, loss=0.4)
    assert tsup.read_heartbeats(str(tmp_path))[0]["step"] == 2


# ---------------------------------------------------------------------------
# the ladder, driven by the reference's scripted stub launchers
# ---------------------------------------------------------------------------

class _StubProc:
    def __init__(self, rc):
        self._rc = rc

    def poll(self):
        return self._rc

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self, timeout=None):
        return self._rc


def _ladder_case(name, d, mod):
    """(launch, width, config kwargs) of the reference's ladder case
    ``name`` for package ``mod``."""
    if name == "order":
        return (lambda w, a: [_StubProc(1) for _ in range(w)]), 4, {}
    if name == "diverged":
        return (lambda w, a: [_StubProc(mod.EXIT_DIVERGED)]), 1, \
            dict(max_restarts=0)
    if name == "hang":
        return (lambda w, a: [_StubProc(None)]), 1, \
            dict(max_restarts=0, startup_timeout=0.2, min_stall_timeout=0.2)

    def launch(width, attempt):
        if attempt == 0:
            return [_StubProc(1)]
        mod.HeartbeatEmitter(d, rank=0).emit(5, loss=0.5)
        return [_StubProc(0)]
    return launch, 1, {}


@pytest.mark.parametrize("case", ["order", "diverged", "hang", "recovery"])
def test_ladder_event_sequences_match(tmp_path, case):
    outs = []
    for tag, mod in (("ref", jsup), ("port", tsup)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        launch, width, kw = _ladder_case(case, d, mod)
        kw = dict(dict(poll_interval=0.005, backoff=0.01, max_restarts=1),
                  **kw)
        sup = mod.Supervisor(launch, width=width, directory=d,
                             config=mod.SupervisorConfig(**kw))
        t0 = time.monotonic()
        out = sup.run(timeout=30.0)
        assert time.monotonic() - t0 < 10.0
        events = sup.ledger.events()
        outs.append((out["outcome"], out["width"], out["restarts"],
                     out["shrinks"], len(out["mttrs"]),
                     [e["event"] for e in events],
                     [e.get("verdict") for e in events
                      if e["event"] == "fault"]))
    assert outs[0] == outs[1]
    want = {"order": "gave_up", "diverged": "gave_up", "hang": "gave_up",
            "recovery": "resolved"}[case]
    assert outs[1][0] == want
    if case == "order":
        assert outs[1][1] == 1 and outs[1][3] == 2  # 4 -> 2 -> 1
    if case == "diverged":
        assert set(outs[1][6]) == {"divergence_exhausted"}
    if case == "hang":
        assert outs[1][6][0] == "hang"


def test_supervisor_validation(tmp_path):
    with pytest.raises(ValueError):
        tsup.Supervisor(lambda w, a: [], width=0, directory=str(tmp_path))
    for kw in (dict(stall_timeout=0), dict(max_restarts=-1),
               dict(shrink_factor=1), dict(min_width=0)):
        with pytest.raises(ValueError):
            tsup.SupervisorConfig(**kw)


# ---------------------------------------------------------------------------
# the supervised loop, port against reference
# ---------------------------------------------------------------------------

def _data():
    rngd = np.random.RandomState(5)
    return (rngd.rand(64, 16).astype(np.float32),
            rngd.randint(0, 4, 64).astype(np.float32))


def _jax_job(d):
    jmx.random.seed(0)
    net = jnn.HybridSequential()
    for _ in range(2):
        net.add(jnn.Dense(16, activation="tanh"))
    net.add(jnn.Dense(13))
    net.initialize(init=jmx.init.Xavier())
    net(jnd.ones((2, 16)))
    step = jmake(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                 optimizer="adam", learning_rate=0.01, lint="off")
    X, Y = _data()
    np.random.seed(3)
    it = JResilient(JIter(X, Y, batch_size=8, shuffle=True))
    weights = [p.data().asnumpy() for p in net.collect_params().values()]
    return step, it, JManager(os.path.join(d, "ckpt")), weights


def _port_job(d, weights=None, **step_kw):
    tmx.random.seed(0)
    with context.device_scope(CPU):
        net = tnn.HybridSequential()
        net.add(tnn.Dense(16, in_units=16, activation="tanh"),
                tnn.Dense(16, in_units=16, activation="tanh"),
                tnn.Dense(13, in_units=16))
    net.initialize(init=tmx.init.Xavier())
    if weights is not None:
        convert.params_from_jax(net, weights)
    kw = dict(optimizer="adam", learning_rate=0.01)
    kw.update(step_kw)
    step = tmake(net, tgluon.loss.SoftmaxCrossEntropyLoss(), device=CPU,
                 **kw)
    X, Y = _data()
    np.random.seed(3)
    it = TResilient(TIter(X, Y, batch_size=8, shuffle=True, ctx=tmx.cpu()))
    return step, it, TManager(os.path.join(d, "ckpt"))


def test_loss_bomb_rollback_matches_reference(tmp_path):
    jstep, jit, jmgr, weights = _jax_job(str(tmp_path / "jax"))
    with jfi.loss_bomb(at=4, factor=1e4):
        ref = jsup.run_supervised(jstep, jit, jmgr, until_step=10,
                                  config=jsup.SupervisorConfig(
                                      checkpoint_every=2))
    step, it, mgr = _port_job(str(tmp_path / "port"), weights)
    with tfi.loss_bomb(at=4, factor=1e4) as st:
        out = tsup.run_supervised(step, it, mgr, until_step=10,
                                  config=tsup.SupervisorConfig(
                                      checkpoint_every=2))
    assert st.fired == 1 and st.params_scaled == 6
    assert out["rollbacks"] == ref["rollbacks"] == 1
    assert out["final_step"] == 10
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL)
    bombed = [v for v in out["losses"] if v > 100]
    assert bombed and all(np.isfinite(bombed))
    events = tsup.read_ledger(mgr.directory)
    jevents = jsup.read_ledger(jmgr.directory)
    assert [e["event"] for e in events] == [e["event"] for e in jevents] \
        == ["divergence", "rollback", "recovered", "done"]
    for name in ("divergence", "rollback"):
        mine = next(e for e in events if e["event"] == name)
        theirs = next(e for e in jevents if e["event"] == name)
        assert mine.get("verdict") == theirs.get("verdict")
        assert mine.get("to_step") == theirs.get("to_step")
    assert events[0]["verdict"] == "loss_explosion"
    assert all(s <= 4 or s >= 6 for s in mgr.steps())
    hb = tsup.read_heartbeats(mgr.directory)[0]
    assert hb["status"] == "done" and hb["step"] == 10
    # the replay after the rollback is the port's own unfaulted run
    step2, it2, mgr2 = _port_job(str(tmp_path / "clean"), weights)
    clean = tsup.run_supervised(step2, it2, mgr2, until_step=10,
                                config=tsup.SupervisorConfig(
                                    checkpoint_every=2))
    assert out["losses"][-6:] == clean["losses"][-6:]
    for a, b in zip(step._gp, step2._gp):
        assert torch.equal(a, b)


def test_skip_streak_escalates_as_reference(tmp_path):
    """A stream poisoned for good under a static scale: the step's
    declared budget fires the skip-streak verdict, and with nothing
    committed the loop raises DivergenceError, as the reference's does."""
    step, it, mgr = _port_job(str(tmp_path), nonfinite="skip",
                              loss_scale=512.0, skip_streak_budget=2)
    assert step.skip_streak_budget == 2
    poisoned = tfi.NaNInjector(step, at_steps=range(10 ** 6))
    with pytest.raises(tsup.DivergenceError, match="skip_streak"):
        tsup.run_supervised(poisoned, it, mgr, until_step=4,
                            config=tsup.SupervisorConfig(
                                checkpoint_every=2))
    assert mgr.steps() == []
    events = tsup.read_ledger(mgr.directory)
    div = [e for e in events if e["event"] == "divergence"][0]
    assert div["verdict"] == "skip_streak" and div["skip_streak"] == 2
    assert any(e["event"] == "rollback_exhausted" for e in events)
    assert tsup.read_heartbeats(mgr.directory)[0]["status"] == "diverged"
    with pytest.raises(ValueError, match="skip_streak_budget"):
        _port_job(str(tmp_path), skip_streak_budget=0)


def test_hang_step_wedges_and_boundary_reads(tmp_path):
    step, it, mgr = _port_job(str(tmp_path))
    with tfi.hang_step(at=1, duration=0.3, count=2) as st:
        t0 = time.monotonic()
        out = tsup.run_supervised(step, it, mgr, until_step=3,
                                  config=tsup.SupervisorConfig(
                                      checkpoint_every=None))
        waited = time.monotonic() - t0
    assert st.hung == 2 and waited >= 0.6
    assert out["final_step"] == 3
    loss = step(*tsup._next_batch(it))
    got = step.boundary_scalars(loss)
    assert got == (float(loss), step.step_count, step.skipped_steps,
                   step.loss_scale)


def test_scale_params_scales_the_f32_masters(tmp_path):
    """Under multi_precision the update reads the master copies in the
    optimizer state: the bomb scales those too, in place, leaves kept."""
    step, _, _ = _port_job(str(tmp_path), optimizer="sgd", momentum=0.9,
                           multi_precision=True)
    before = [p.detach().clone() for p in step._gp]
    ids = [id(p) for p in step._gp]
    assert tsup._scale_params(step, 4.0) == len(step._gp)
    for p, b, s in zip(step._gp, before, step._opt_state):
        assert p.is_leaf and p.requires_grad
        assert torch.equal(p.detach(), b * 4.0)
        assert torch.equal(step.opt._unpack(s)[1], b * 4.0)
    assert [id(p) for p in step._gp] == ids


def test_auto_sync_degrades_and_recovers_under_supervision(tmp_path):
    """The straggler scenario's ladder leg: a ``sync="auto"`` step under
    run_supervised sees a lagging phantom peer, degrades to async (a
    ``sync_degrade`` event), recovers once the peer is done, and both
    rungs ran steps."""
    step, it, mgr = _port_job(str(tmp_path), sync="auto", staleness_bound=4)
    step.sync_policy.recover_after = 3
    cfg = tsup.SupervisorConfig(straggler_factor=1.2, straggler_min_lag=2)
    phantom = tsup.HeartbeatEmitter(mgr.directory, rank=1)
    phantom.emit(0, status="running")
    modes = []

    def on_step(hb):
        modes.append(step.sync_mode)
        if hb["step"] >= 6:
            phantom.emit(hb["step"], status="done")

    out = tsup.run_supervised(step, it, mgr, until_step=12, config=cfg,
                              on_step=on_step)
    assert out["final_step"] == 12
    events = tsup.read_ledger(mgr.directory)
    names = [e["event"] for e in events]
    assert names.index("sync_degrade") < names.index("sync_recover")
    deg = next(e for e in events if e["event"] == "sync_degrade")
    assert deg["mode"] == "async" and deg["stragglers"] == [1]
    assert step.sync_mode == "allreduce"
    assert "async" in modes and "allreduce" in modes
    assert all(np.isfinite(out["losses"]))


def test_supervise_torch_kill_respawn_bit_identical(tmp_path):
    """``tools/supervise_torch.py --cpu`` with kill_process at call 3 of
    its one rank: respawned, restored from step 2, and the respawned
    attempt's losses are the in-process run's steps 3-8 bit for bit."""
    outdir = str(tmp_path / "run")
    os.makedirs(outdir)
    args = supervise_torch.parser().parse_args(
        ["--cpu", "--dir", outdir, "--backoff", "0.1", "--timeout", "120"])
    out = supervise_torch.supervise_once(args,
                                         chaos_spec="kill_process:at=3")
    assert out["outcome"] == "resolved", out
    assert out["restarts"] == 1 and out["final_step"] == 8
    assert out["torn_visible"] == 0
    for ev in supervise_torch.REQUIRED_EVENTS["kill_process"]:
        assert ev in out["events"], (ev, out["events"])
    assert out["mttrs"] and max(out["mttrs"]) < 60.0
    with open(os.path.join(outdir, "result_rank0.json")) as f:
        res = json.load(f)
    assert res["attempt"] == 1 and res["status"] == "done"
    assert res["restored_from"] == 2
    step, it, mgr = supervise_torch.build_worker_job(
        str(tmp_path / "ref"), device="cpu")[:3]
    ref = tsup.run_supervised(step, it, mgr, until_step=8,
                              config=tsup.SupervisorConfig(
                                  checkpoint_every=2))
    it.close()
    assert res["losses"] == ref["losses"][2:]


# ---------------------------------------------------------------------------
# the launchers: the cases of tests/test_launch.py on both
# ---------------------------------------------------------------------------

_FLAKY = ("import os,sys;"
          "sys.exit(0 if int(os.environ['MXNET_RESTART_COUNT']) > 0 "
          "else 7)")
_LAUNCHERS = {"launch": launch.launch_local,
              "launch_torch": launch_torch.launch_local}


@pytest.mark.parametrize("which", sorted(_LAUNCHERS))
@pytest.mark.parametrize("case", ["restart_recovers", "no_restart",
                                  "budget_exhausted"])
def test_launchers(which, case):
    run = _LAUNCHERS[which]
    if case == "restart_recovers":
        assert run(2, [sys.executable, "-c", _FLAKY], max_restarts=2,
                   grace=5.0) == 0
    elif case == "no_restart":
        assert run(2, [sys.executable, "-c", _FLAKY], max_restarts=0,
                   grace=5.0) == 7
    else:
        assert run(1, [sys.executable, "-c", "import sys;sys.exit(3)"],
                   max_restarts=2, grace=5.0) == 3


def test_spawn_workers_env_and_group_kill():
    """``spawn_workers``: the DMLC_* protocol per rank, each rank in a
    session of its own, killed with its process group."""
    code = ("import os,json,time;print(json.dumps({k: os.environ[k] for k "
            "in ('DMLC_WORKER_ID','DMLC_NUM_WORKER','MXNET_RESTART_COUNT',"
            "'DMLC_PS_ROOT_PORT')}), flush=True);"
            "print(os.getsid(0) == os.getpid(), flush=True);time.sleep(60)")
    import subprocess

    procs = launch_torch.spawn_workers(2, [sys.executable, "-c", code],
                                       attempt=3, stdout=subprocess.PIPE,
                                       text=True)
    try:
        seen = []
        for p in procs:
            env = json.loads(p.popen.stdout.readline())
            assert p.popen.stdout.readline().strip() == "True"
            seen.append(env)
        assert [e["DMLC_WORKER_ID"] for e in seen] == ["0", "1"]
        assert {e["DMLC_NUM_WORKER"] for e in seen} == {"2"}
        assert {e["MXNET_RESTART_COUNT"] for e in seen} == {"3"}
        assert len({e["DMLC_PS_ROOT_PORT"] for e in seen}) == 1
    finally:
        for p in procs:
            p.kill()
    for p in procs:
        assert p.wait(timeout=10) == -9
