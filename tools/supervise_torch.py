#!/usr/bin/env python
"""Self-healing training of the PyTorch port: launcher, watchdog and chaos
matrix (counterpart of ``tools/supervise.py``;
``incubator_mxnet_tpu_torch/parallel/supervisor.py``).

Two modes in one file, so that a respawned rank runs what the supervisor
runs:

- **supervisor mode** (the default): start ``-n`` ranks of the built-in
  supervised worker through ``tools/launch_torch.py`` (the ``DMLC_*``
  protocol, ``MXNET_RESTART_COUNT``; each rank in a session of its own)
  and drive detection → ladder → resume until the job resolves or the
  ladder gives up;
- **worker mode** (``--worker``, started by the supervisor): one rank of
  a small deterministic job, :func:`build_worker_job` (two ``Dense(16,
  tanh)`` and a ``Dense(13)``, adam at lr 0.01, a process-spanning dp
  mesh with ``zero=1`` over gloo), driven by
  :func:`~incubator_mxnet_tpu_torch.parallel.supervisor.run_supervised`
  with heartbeats, periodic checkpoints and in-process rollback.  The
  chaos of ``MXTPU_CHAOS`` arms itself on attempt 0 only, so every
  injected failure is recoverable by a restart.

``--chaos SCENARIO`` runs one scenario of the matrix (``kill_process``,
``hang_step``, ``straggler_process``, ``host_loss_during_save``,
``loss_bomb``); ``--chaos all`` runs them all and exits 1 if any ends
unrecovered, misses a required health-ledger event, exceeds the MTTR
bound or leaves a torn checkpoint visible.  ``--format json`` prints one
JSON record per scenario.  The ranks run on the card unless ``--cpu``
asks for the CPU (as the tests do); a rank that finds no card fails.

The job's ``make_train_step`` takes no ``lint=`` argument: the port has
no analysis layer yet, so the reference's ``lint="error"`` is left out.

    python tools/supervise_torch.py --cpu --chaos kill_process
    python tools/supervise_torch.py --chaos all --format json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import socket
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_REPO, "tools")
for _p in (_REPO, _TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: scenario -> (chaos spec defaults, minimum width, supervisor-config
#: overrides).  ``rank`` -1 means the last rank (rank 0, which commits
#: the checkpoints, stays alive in the scenarios of several ranks).
SCENARIOS = {
    "kill_process": dict(spec=dict(at=3), width=1, cfg={}),
    "hang_step": dict(spec=dict(at=3, duration=600.0), width=1, cfg={}),
    "straggler_process": dict(
        spec=dict(at=4, delay=1.0), width=2,
        # the slowdown starts after the coordinated step-4 save, so the
        # phase after it is uncoupled (a coordinated save throttles every
        # rank to the slowest, which would hide the lag) and the recovery
        # resumes from the committed step 4.  The verdict thresholds are
        # loosened for the short lag window, and the stall floor raised so
        # the healthy rank waiting in its last save's marker wait cannot
        # trip the hang detector before the straggler verdict does.
        # sync="auto" arms the ladder: before the grace window escalates
        # to a restart, every rank's step observes the straggler verdict
        # and degrades allreduce -> async ("sync_degrade" in the ledger).
        args=dict(checkpoint_every=4, sync="auto",
                  straggler_factor=1.2, straggler_min_lag=2),
        cfg=dict(straggler_factor=1.2, straggler_min_lag=2,
                 straggler_grace=1.0, min_stall_timeout=8.0)),
    "host_loss_during_save": dict(spec=dict(save=1), width=2,
                                  cfg=dict(min_stall_timeout=15.0)),
    "loss_bomb": dict(spec=dict(at=4, factor=1e4), width=1, cfg={}),
}

#: the events a green scenario must leave in the merged health ledger
REQUIRED_EVENTS = {
    "kill_process": ("launch", "fault", "restart", "recovered",
                     "resolved"),
    "hang_step": ("launch", "heartbeat_gap", "fault", "restart",
                  "recovered", "resolved"),
    "straggler_process": ("launch", "straggler", "sync_degrade", "fault",
                          "restart", "recovered", "resolved"),
    "host_loss_during_save": ("launch", "fault", "restart", "recovered",
                              "resolved"),
    "loss_bomb": ("launch", "divergence", "rollback", "recovered",
                  "done", "resolved"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# worker mode (the rank's body)
# ---------------------------------------------------------------------------

def build_worker_job(outdir: str, checkpoint_every=2,
                     commit_timeout: float = 10.0, skip_budget=None,
                     sync: str = "allreduce", straggler_factor: float = 3.0,
                     straggler_min_lag: int = 4, device=None):
    """The deterministic supervised job every rank runs (module-level, so
    a test can run the same job in its own process as the bit-exact
    reference).  ``device``: None (the card) or ``"cpu"``.  The step
    bound is the caller's (``run_supervised(until_step=)``).  Returns
    ``(step, data_iter, manager, config, rank, nproc)``."""
    import numpy as np

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, gluon
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.io import NDArrayIter, ResilientIter
    from incubator_mxnet_tpu_torch.parallel import (CheckpointManager,
                                                    SupervisorConfig,
                                                    distributed,
                                                    make_mesh,
                                                    make_train_step)
    from incubator_mxnet_tpu_torch.parallel.mesh import global_devices

    distributed.initialize(device=device)  # DMLC_*; no-op at world size 1
    rank = distributed.process_index()
    nproc = distributed.process_count()
    dev = distributed.local_device(device)
    spmd = nproc > 1 and distributed.collectives_supported()

    mx.random.seed(0)
    with context.device_scope(dev):
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=16, activation="tanh"),
                nn.Dense(16, in_units=16, activation="tanh"),
                nn.Dense(13, in_units=16))
    net.initialize(init=mx.init.Xavier())
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    if sync == "allreduce":
        mesh = make_mesh({"dp": -1 if spmd else 1},
                         devices=global_devices(device) if spmd else [dev])
        step = make_train_step(net, loss, optimizer="adam",
                               learning_rate=0.01, mesh=mesh,
                               batch_axis="dp", zero=1, device=dev,
                               skip_streak_budget=skip_budget)
    else:
        # the async-capable rung (sync="async"/"auto"): one replica a
        # rank process exchanging through a ParamService, no mesh
        # collectives; the straggler scenario degrades to it
        step = make_train_step(net, loss, optimizer="adam",
                               learning_rate=0.01, sync=sync,
                               staleness_bound=4, device=dev,
                               skip_streak_budget=skip_budget)
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"),
                            commit_timeout=commit_timeout)

    rngd = np.random.RandomState(5)
    X = rngd.rand(64, 16).astype(np.float32)
    Y = rngd.randint(0, 4, 64).astype(np.float32)
    np.random.seed(3)
    it = ResilientIter(NDArrayIter(X, Y, batch_size=8, shuffle=True,
                                   ctx=mx.cpu()))
    if spmd and sync == "allreduce":
        # one program spans the processes: each rank feeds its rows of
        # the global batch
        it = RowSlice(it, rank * 8 // nproc, (rank + 1) * 8 // nproc)
    cfg = SupervisorConfig(checkpoint_every=checkpoint_every,
                           straggler_factor=straggler_factor,
                           straggler_min_lag=straggler_min_lag)
    return step, it, mgr, cfg, rank, nproc


class RowSlice:
    """Feed this process's rows ``[lo, hi)`` of each global batch, and
    hand the iterator-state protocol to the wrapped iterator, so a
    checkpoint holds the global stream's position."""

    def __init__(self, inner, lo: int, hi: int):
        self.inner, self.lo, self.hi = inner, lo, hi

    def next(self):
        from incubator_mxnet_tpu_torch.ndarray import NDArray

        b = self.inner.next()
        b.data = [NDArray(d._data[self.lo:self.hi].contiguous())
                  for d in b.data]
        b.label = [NDArray(v._data[self.lo:self.hi].contiguous())
                   for v in b.label]
        return b

    def reset(self):
        self.inner.reset()

    def close(self):
        self.inner.close()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)


def _parse_chaos(spec: str):
    """``"name:k=v,k=v"`` -> ``(name, {k: float or int})``."""
    name, _, rest = spec.partition(":")
    kw = {}
    for part in filter(None, rest.split(",")):
        k, _, v = part.partition("=")
        kw[k] = float(v) if ("." in v or "e" in v.lower()) else int(v)
    return name, kw


@contextlib.contextmanager
def _die_at_step(at: int):
    """SIGKILL this process just before supervised step call ``at``
    (0-based): the kill_process scenario, through the same
    ``supervisor._run_step`` choke point as the other injectors."""
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.parallel import supervisor as sup

    real = sup._run_step
    state = {"seen": 0}

    def lethal(step, x, y):
        i = state["seen"]
        state["seen"] += 1
        if i == at:
            fi.kill_process()
        return real(step, x, y)

    sup._run_step = lethal
    try:
        yield
    finally:
        sup._run_step = real


@contextlib.contextmanager
def _die_during_save(save_index: int):
    """Arm ``fault_injection.host_loss_during_save`` on the
    ``save_index``-th boundary save (0-based): the process dies on the
    first file write of that save, leaving a torn stage that the commit
    protocol must never publish."""
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.parallel import supervisor as sup

    real = sup._save_checkpoint
    state = {"seen": 0}

    def lethal(step, mgr, it):
        i = state["seen"]
        state["seen"] += 1
        if i == save_index:
            with fi.host_loss_during_save(at=0):
                return real(step, mgr, it)
        return real(step, mgr, it)

    sup._save_checkpoint = lethal
    try:
        yield
    finally:
        sup._save_checkpoint = real


def chaos_context(name: str, kw: dict):
    """The injector of scenario ``name`` with its keywords ``kw``."""
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi

    if name == "kill_process":
        return _die_at_step(int(kw.get("at", 3)))
    if name == "hang_step":
        return fi.hang_step(at=int(kw.get("at", 3)),
                            duration=float(kw.get("duration", 600.0)))
    if name == "straggler_process":
        # a per-step slowdown: a long run of short wedges
        return fi.hang_step(at=int(kw.get("at", 4)),
                            duration=float(kw.get("delay", 1.0)),
                            count=10 ** 6)
    if name == "host_loss_during_save":
        return _die_during_save(int(kw.get("save", 1)))
    if name == "loss_bomb":
        return fi.loss_bomb(at=int(kw.get("at", 4)),
                            factor=float(kw.get("factor", 1e4)))
    raise SystemExit("unknown chaos scenario %r (known: %s)"
                     % (name, ", ".join(sorted(SCENARIOS))))


def run_worker(outdir: str, job, until_step: int, extra=None) -> int:
    """One rank's supervised run of ``job`` (what :func:`build_worker_job`
    returns) to ``until_step``: the chaos of ``MXTPU_CHAOS`` armed on
    attempt 0 in its victim rank, the result written to
    ``<outdir>/result_rank<r>.json`` (``extra(step)``'s fields added).
    Returns the exit code: 0, or ``EXIT_DIVERGED``."""
    from incubator_mxnet_tpu_torch.parallel.supervisor import (
        EXIT_DIVERGED, DivergenceError, run_supervised)

    step, it, mgr, cfg, rank, nproc = job
    attempt = int(os.environ.get("MXNET_RESTART_COUNT", "0"))
    chaos_env = os.environ.get("MXTPU_CHAOS", "")
    stack = contextlib.ExitStack()
    if chaos_env and attempt == 0:
        name, kw = _parse_chaos(chaos_env)
        victim = int(kw.pop("rank", nproc - 1))
        if victim < 0:
            victim += nproc
        if rank == victim:
            stack.enter_context(chaos_context(name, kw))

    def dump(payload):
        path = os.path.join(outdir, "result_rank%d.json" % rank)
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)

    with stack:
        try:
            res = run_supervised(step, it, mgr, until_step=until_step,
                                 config=cfg, rank=rank)
        except DivergenceError as e:
            dump({"rank": rank, "attempt": attempt, "status": "diverged",
                  "error": str(e)})
            return EXIT_DIVERGED
    it.close()
    dump({"rank": rank, "attempt": attempt, "status": "done",
          "width": nproc, **res, **(extra(step) if extra else {})})
    print("supervised worker done (rank %d/%d, attempt %d, step %d, "
          "%d rollbacks)" % (rank, nproc, attempt, res["final_step"],
                             res["rollbacks"]), flush=True)
    return 0


def worker_main(args) -> int:
    job = build_worker_job(
        args.dir, checkpoint_every=args.checkpoint_every,
        commit_timeout=args.commit_timeout, sync=args.sync,
        straggler_factor=args.straggler_factor,
        straggler_min_lag=args.straggler_min_lag,
        device="cpu" if args.cpu else None)
    return run_worker(args.dir, job, args.steps)


# ---------------------------------------------------------------------------
# supervisor mode
# ---------------------------------------------------------------------------

def worker_command(args):
    """This file in worker mode with ``args``' job settings."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--dir", args.dir, "--steps", str(args.steps),
           "--checkpoint-every", str(args.checkpoint_every),
           "--commit-timeout", str(args.commit_timeout),
           "--sync", args.sync,
           "--straggler-factor", str(args.straggler_factor),
           "--straggler-min-lag", str(args.straggler_min_lag)]
    if args.cpu:
        cmd.append("--cpu")
    return cmd


def make_launcher(args, chaos_spec: str = "", command=None):
    """A ``Supervisor``-shaped ``launch(width, attempt)``: ``command`` (by
    default :func:`worker_command`) started ``width`` times through
    ``launch_torch.spawn_workers`` on a fresh rendezvous port per attempt,
    each rank in a session of its own."""
    from launch_torch import spawn_workers

    cmd = list(command) if command is not None else worker_command(args)
    env = {"PYTHONPATH": _REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    if chaos_spec:
        env["MXTPU_CHAOS"] = chaos_spec

    def launch(width, attempt):
        return spawn_workers(width, cmd, port=_free_port(), extra_env=env,
                             attempt=attempt)

    return launch


def make_config(args, overrides: dict = ()):
    from incubator_mxnet_tpu_torch.parallel import SupervisorConfig

    kw = dict(max_restarts=args.max_restarts,
              min_stall_timeout=args.min_stall,
              startup_timeout=args.startup_timeout,
              backoff=args.backoff,
              checkpoint_every=args.checkpoint_every)
    kw.update(dict(overrides or {}))
    return SupervisorConfig(**kw)


def torn_visible(ckpt_dir: str) -> int:
    """Committed-looking step directories whose manifest is missing or
    unreadable: the torn checkpoints a restore could see (always 0; the
    ``.tmp-step-*`` stages are fine, a torn ``step-*`` directory is a
    broken commit protocol)."""
    n = 0
    if not os.path.isdir(ckpt_dir):
        return 0
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step-"):
            continue
        try:
            with open(os.path.join(ckpt_dir, name, "manifest.json")) as f:
                json.load(f)
        except (OSError, ValueError):
            n += 1
    return n


def supervise_once(args, chaos_spec: str = "", cfg_overrides=(),
                   launch=None) -> dict:
    """One supervised job (``launch``: by default :func:`make_launcher`'s)
    to its resolution; its outcome with the ledger's events, the MTTRs and
    the torn checkpoints visible."""
    from incubator_mxnet_tpu_torch.parallel import Supervisor
    from incubator_mxnet_tpu_torch.parallel.supervisor import read_ledger

    # heartbeats, the ranks' ledgers and the committed steps all live in
    # the checkpoint directory, beside what they describe
    ckpt_dir = os.path.join(args.dir, "ckpt")
    sup = Supervisor(launch or make_launcher(args, chaos_spec),
                     width=args.n, directory=ckpt_dir,
                     config=make_config(args, cfg_overrides))
    try:
        out = sup.run(timeout=args.timeout)
    finally:
        sup._kill_job()
    events = read_ledger(ckpt_dir)
    out["events"] = [e["event"] for e in events]
    out["mttrs"] = sorted(set(out.get("mttrs", []))
                          | {float(e["mttr"]) for e in events
                             if e["event"] == "recovered"
                             and "mttr" in e})
    out["torn_visible"] = torn_visible(ckpt_dir)
    return out


def run_chaos(scenario: str, args, fmt: str) -> dict:
    info = SCENARIOS[scenario]
    spec = scenario + ":" + ",".join(
        "%s=%s" % (k, v) for k, v in info["spec"].items())
    sub = argparse.Namespace(**vars(args))
    sub.n = max(args.n, info["width"])
    sub.dir = os.path.join(args.dir, scenario)
    for k, v in info.get("args", {}).items():
        setattr(sub, k, v)
    os.makedirs(sub.dir, exist_ok=True)
    out = supervise_once(sub, chaos_spec=spec, cfg_overrides=info["cfg"])
    missing = [ev for ev in REQUIRED_EVENTS[scenario]
               if ev not in out["events"]]
    mttr = max(out["mttrs"], default=None)
    ok = (out["outcome"] == "resolved" and not missing
          and out["torn_visible"] == 0
          and mttr is not None and mttr <= args.mttr_bound)
    rec = {"scenario": scenario, "ok": ok, "outcome": out["outcome"],
           "restarts": out["restarts"], "shrinks": out["shrinks"],
           "mttr": mttr, "mttr_bound": args.mttr_bound,
           "missing_events": missing,
           "torn_visible": out["torn_visible"],
           "final_step": out.get("final_step"),
           "width": out["width"]}
    if fmt == "json":
        print(json.dumps(rec, sort_keys=True), flush=True)
    else:
        print("[chaos %-22s] %s  restarts=%d shrinks=%d mttr=%s%s"
              % (scenario, "OK " if ok else "FAIL", rec["restarts"],
                 rec["shrinks"],
                 "%.2fs" % mttr if mttr is not None else "-",
                 " missing=%s" % missing if missing else ""),
              flush=True)
    return rec


def parser():
    ap = argparse.ArgumentParser(
        description="Self-healing training supervisor of the PyTorch port")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # the rank's body
    ap.add_argument("-n", "--num-workers", dest="n", type=int, default=1)
    ap.add_argument("--steps", type=int, default=8,
                    help="applied steps to train to (default 8)")
    ap.add_argument("--dir", default=None,
                    help="run directory (checkpoints, heartbeats, health "
                         "ledger); default: a new temporary directory")
    ap.add_argument("--chaos", default=None,
                    help="inject one scenario (%s) or 'all'"
                         % "|".join(sorted(SCENARIOS)))
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (gloo); by default each "
                         "rank drives the card")
    ap.add_argument("--sync", choices=("allreduce", "async", "auto"),
                    default="allreduce",
                    help="the workers' gradient exchange: the allreduce "
                         "step, the bounded-staleness async parameter "
                         "service, or the straggler-driven ladder between "
                         "them")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--straggler-min-lag", type=int, default=4)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--commit-timeout", type=float, default=10.0)
    ap.add_argument("--min-stall", type=float, default=2.0,
                    help="stall-timeout floor, seconds (the EMA "
                         "calibration never goes below it)")
    ap.add_argument("--startup-timeout", type=float, default=60.0)
    ap.add_argument("--backoff", type=float, default=0.25)
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="bound on one supervised run, seconds")
    ap.add_argument("--mttr-bound", type=float, default=60.0,
                    help="chaos gate: the most seconds from a fault's "
                         "detection to training resumed")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.worker:
        if not args.dir:
            ap.error("--worker requires --dir")
        return worker_main(args)
    if args.dir is None:
        args.dir = tempfile.mkdtemp(prefix="mxtorch_supervise_")
        print("run dir: %s" % args.dir, file=sys.stderr, flush=True)
    # stopped from outside, the supervisor still kills its ranks (each
    # in a session of its own) on the way out
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))

    if args.chaos:
        names = sorted(SCENARIOS) if args.chaos == "all" else \
            [s.strip() for s in args.chaos.split(",")]
        unknown = [s for s in names if s not in SCENARIOS]
        if unknown:
            ap.error("unknown chaos scenario(s) %s (known: %s)"
                     % (unknown, ", ".join(sorted(SCENARIOS))))
        records = [run_chaos(s, args, args.format) for s in names]
        bad = [r["scenario"] for r in records if not r["ok"]]
        if args.format == "text":
            print("chaos matrix: %d/%d green%s"
                  % (len(records) - len(bad), len(records),
                     " (FAILED: %s)" % ", ".join(bad) if bad else ""),
                  flush=True)
        return 1 if bad else 0

    out = supervise_once(args)
    if args.format == "json":
        print(json.dumps(out, sort_keys=True, default=str), flush=True)
    else:
        print("supervise: %s (width %d, %d restarts, %d shrinks, "
              "final step %s)" % (out["outcome"], out["width"],
                                  out["restarts"], out["shrinks"],
                                  out.get("final_step")), flush=True)
    return 0 if out["outcome"] == "resolved" else 1


if __name__ == "__main__":
    sys.exit(main())
