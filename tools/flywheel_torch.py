#!/usr/bin/env python
"""Closed train->serve flywheel of the PyTorch/CUDA port (port of
``tools/flywheel.py``).

One process, the whole loop:

1. a ServeEngine + ContinuousBatcher serve open-loop Poisson traffic,
   and the served payloads are recorded: the loadtest traffic becomes
   the training stream (labels from a fixed teacher projection, so the
   run is reproducible);
2. a supervised trainer (``parallel/supervisor.py::run_supervised``:
   divergence rollback, atomic checkpoints every ``--checkpoint-every``
   steps) consumes that stream through ``ResilientIter`` in a thread;
3. the promotion daemon (``serve/flywheel.py``) watches the checkpoint
   directory, committed steps only, and walks each candidate through
   the gauntlet (checksummed load -> held-out metric against the
   incumbent through ``shadow_infer`` -> GL011 and the canary), swapping
   survivors into the live engine under the serving load and appending
   every verdict to the JSONL promotion ledger.

Chaos legs close the loop both ways:

- ``--chaos loss_bomb`` plants a finite gradient bomb mid-stream: the
  supervisor must roll training back (ledger: divergence -> rollback ->
  recovered), and a force-committed diverged checkpoint must be
  quarantined by the gauntlet with no promoted version from it; the
  engine's ``rollback_count`` stays 0 because the metric stage rejects
  it before the swap path;
- ``--chaos swap_storm`` fires 6 back-to-back promotions (one poisoned)
  under sustained load: p99 within the declared bound, no capture after
  warmup, exactly one version attributed to every row, the incumbent
  restored bitwise on the poison.

Prints one JSON record; exits 1 on any broken contract.  The reference's
``lint="error"`` and ``numerics="error"`` (its graftrange stage) walk
jaxprs and are not ported.  Serves and trains on the card unless
``--device cpu`` is given.

Examples::

  python tools/flywheel_torch.py --steps 10 --qps 200
  python tools/flywheel_torch.py --chaos loss_bomb
  python tools/flywheel_torch.py --device cpu --chaos swap_storm
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T0 = time.time()


def log(msg):
    print("[flywheel_torch %6.1fs] %s" % (time.time() - T0, msg),
          file=sys.stderr, flush=True)


#: the flywheel model (the supervisor's job shape): 16-dim requests,
#: 13 classes
IN_DIM, N_CLASSES = 16, 13


def build_net(seed=0, device=None):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context
    from incubator_mxnet_tpu_torch.gluon import nn

    mx.random.seed(seed)
    with context.device_scope(context.resolve(device)):
        net = nn.HybridSequential()
        for _ in range(2):
            net.add(nn.Dense(16, activation="tanh"))
        net.add(nn.Dense(N_CLASSES))
    net.initialize(init=mx.init.Xavier())
    net.shape_init((2, IN_DIM))
    return net


def teacher_labels(X):
    """Deterministic labels for recorded traffic: argmax of a fixed
    random projection, with 30% label noise (the reference's: without
    the noise a loss-bombed net can be confidently right on whole
    batches, and the zero-CE steps hold the divergence detector's loss
    EMA under its threshold)."""
    import numpy as np

    W = np.random.RandomState(7).randn(IN_DIM, N_CLASSES)
    Y = np.argmax(np.asarray(X) @ W, axis=1).astype(np.float32)
    nz = np.random.RandomState(11)
    flip = nz.rand(len(Y)) < 0.3
    Y[flip] = nz.randint(0, N_CLASSES, int(flip.sum())).astype(np.float32)
    return Y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10,
                    help="trainer steps (checkpoints land every "
                         "--checkpoint-every)")
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--requests", type=int, default=120,
                    help="requests per loadtest window (capture + live)")
    ap.add_argument("--chaos", choices=("loss_bomb", "swap_storm"),
                    default=None)
    ap.add_argument("--dir", default=None,
                    help="working dir (default: a fresh tempdir)")
    ap.add_argument("--device", default=None,
                    help="where to serve and train (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, gluon
    from incubator_mxnet_tpu_torch.io import NDArrayIter, ResilientIter
    from incubator_mxnet_tpu_torch.parallel import (CheckpointManager,
                                                    SupervisorConfig,
                                                    make_train_step,
                                                    run_supervised)
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.parallel.supervisor import read_ledger
    from incubator_mxnet_tpu_torch.serve import (ContinuousBatcher,
                                                 PromotionDaemon,
                                                 ServeEngine,
                                                 load_candidate_params,
                                                 poisson_loadtest,
                                                 read_promotions)

    device = context.resolve(args.device)
    outdir = args.dir or tempfile.mkdtemp(prefix="flywheel-")
    os.makedirs(outdir, exist_ok=True)
    failures = []

    # -- serving side: engine + batcher, warmed (no capture after this)
    eng = ServeEngine(build_net(args.seed, device), buckets=(8, 16),
                      device=device)
    eng.warmup(np.zeros((IN_DIM,), np.float32))
    batcher = ContinuousBatcher(eng, max_delay=0.005, max_queue=1024)

    # -- phase 1: serve AND record the traffic as the training stream
    rs = np.random.RandomState(args.seed)
    pool = rs.rand(64, IN_DIM).astype(np.float32)
    captured = []

    def payload(i, rng):
        row = pool[i % 64]
        captured.append(row)
        return row

    try:
        cap = poisson_loadtest(batcher, payload, qps=args.qps,
                               n_requests=args.requests, seed=args.seed,
                               extra={"leg": "capture"})
        log("capture: " + cap.format())
        X = np.stack(captured)
        Y = teacher_labels(X)

        # -- trainer over the recorded stream (same-lineage init: the
        # incumbent is where training starts)
        tnet = build_net(args.seed, device)
        step = make_train_step(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                               optimizer="adam", learning_rate=0.01,
                               device=device)
        np.random.seed(3)
        it = ResilientIter(NDArrayIter(X, Y, batch_size=8, shuffle=True,
                                       ctx=mx.cpu()))
        mgr = CheckpointManager(os.path.join(outdir, "ckpt"))
        cfg = SupervisorConfig(checkpoint_every=args.checkpoint_every)
        train_out = {}

        def train():
            try:
                if args.chaos == "loss_bomb":
                    with fi.loss_bomb(at=4, factor=1e4) as st:
                        train_out.update(run_supervised(
                            step, it, mgr, until_step=args.steps,
                            config=cfg))
                    train_out["bomb_fired"] = st.fired
                else:
                    train_out.update(run_supervised(
                        step, it, mgr, until_step=args.steps, config=cfg))
            except BaseException as e:  # surfaced below, never silent
                train_out["error"] = "%s: %s" % (type(e).__name__, e)

        # -- promotion daemon: held-out rows from the recorded stream
        daemon = PromotionDaemon(mgr, eng, held_out=(X[:16], Y[:16]),
                                 metric_slack=0.5)
        stop = threading.Event()

        def promote():
            while not stop.is_set():
                daemon.poll_once(timeout=0.2)

        tthread = threading.Thread(target=train, name="flywheel-trainer")
        pthread = threading.Thread(target=promote, name="flywheel-daemon",
                                   daemon=True)
        tthread.start()
        pthread.start()
        try:
            # -- phase 2: live window, promotions land under this traffic
            live = poisson_loadtest(batcher, lambda i, rng: pool[i % 64],
                                    qps=args.qps, n_requests=args.requests,
                                    seed=args.seed + 1,
                                    extra={"leg": "live"})
            log("live:    " + live.format())
            tthread.join(timeout=300.0)
            if tthread.is_alive():
                failures.append("trainer failed to finish")
            if train_out.get("error"):
                failures.append("trainer error: %s" % train_out["error"])
            # drain the daemon: every committed candidate gets its verdict
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                newest = mgr.latest_committed()
                if newest is None or daemon.last_processed == newest:
                    break
                time.sleep(0.1)

            if args.chaos == "loss_bomb":
                # the diverged-checkpoint arm: training rolled back, and a
                # force-committed diverged candidate is quarantined with
                # no promoted version from it
                if train_out.get("rollbacks", 0) < 1:
                    failures.append("loss_bomb did not trigger a training "
                                    "rollback")
                events = [e["event"] for e in read_ledger(str(mgr.directory))]
                for want in ("divergence", "rollback", "recovered"):
                    if want not in events:
                        failures.append("training ledger missing %r" % want)
                newest = mgr.latest_committed()
                raw = load_candidate_params(mgr, newest)
                promoted_before = daemon.promoted_count
                rb_before = eng.rollback_count
                mgr.save(newest + 1,
                         {"params": [np.asarray(a) * 1e4 for a in raw]})
                deadline = time.monotonic() + 60.0
                while daemon.last_processed != newest + 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                if daemon.last_processed != newest + 1:
                    failures.append("daemon never saw the diverged "
                                    "candidate")
                if daemon.promoted_count != promoted_before:
                    failures.append("a DIVERGED checkpoint was promoted")
                if eng.rollback_count != rb_before:
                    failures.append("diverged candidate reached the canary "
                                    "(metric stage should reject first)")
        finally:
            stop.set()
            pthread.join(timeout=10.0)
            tthread.join(timeout=60.0)

        storm_rec = None
        if args.chaos == "swap_storm":
            with fi.swap_storm(eng, n_swaps=6, interval=0.02, poison_at=3,
                               seed=args.seed) as st:
                storm = poisson_loadtest(batcher,
                                         lambda i, rng: pool[i % 64],
                                         qps=args.qps,
                                         n_requests=args.requests,
                                         seed=args.seed + 2,
                                         extra={"leg": "swap_storm"})
            log("storm:   " + storm.format())
            bound_ms = live.p99_ms * 10.0 + 250.0
            if storm.p99_ms > bound_ms:
                failures.append("storm p99 %.2fms beyond bound %.2fms"
                                % (storm.p99_ms, bound_ms))
            if storm.hung or storm.unattributed:
                failures.append("storm: %d hung, %d unattributed"
                                % (storm.hung, storm.unattributed))
            if st.error or not st.poison_rejected \
                    or not st.incumbent_bitwise_ok:
                failures.append("storm: error=%r poison_rejected=%s "
                                "bitwise_ok=%s"
                                % (st.error, st.poison_rejected,
                                   st.incumbent_bitwise_ok))
            if not st.committed:
                failures.append("storm landed 0 swaps -- nothing was "
                                "stress-tested")
            storm_rec = {"p99_ms": round(storm.p99_ms, 3),
                         "bound_ms": round(bound_ms, 3),
                         "promotions": storm.promotions,
                         "rollbacks": storm.rollbacks,
                         "versions": storm.versions,
                         "unattributed": storm.unattributed,
                         "committed": st.committed}
    finally:
        batcher.close()

    # -- the closed-loop contracts
    ledger = read_promotions(daemon.ledger_path)
    promoted = [e for e in ledger if e["event"] == "promoted"]
    if args.chaos != "loss_bomb" and not promoted:
        failures.append("no candidate survived the gauntlet in a clean run")
    if eng.recompile_count:
        failures.append("%d capture(s) after warmup" % eng.recompile_count)
    for rep in (cap, live):
        if rep.hung:
            failures.append("%d hung future(s)" % rep.hung)
        if rep.unattributed:
            failures.append("%d unattributed row(s)" % rep.unattributed)

    rec = {"metric": "flywheel", "value": len(promoted),
           "unit": "promotions", "chaos": args.chaos,
           "device": str(device),
           "trained_steps": train_out.get("final_step"),
           "train_rollbacks": train_out.get("rollbacks"),
           "promoted": [e["step"] for e in promoted],
           "quarantined": [(e["step"], e["stage"]) for e in ledger
                           if e["event"] == "quarantined"],
           "serving_version": eng.params_version,
           "serving_rollbacks": eng.rollback_count,
           "recompiles": eng.recompile_count,
           "live_versions": live.versions,
           "live_promotions": live.promotions,
           "ledger": daemon.ledger_path,
           "failures": failures}
    if storm_rec is not None:
        rec["swap_storm"] = storm_rec
    print(json.dumps(rec), flush=True)
    if failures:
        log("FAIL: " + "; ".join(failures))
        return 1
    log("ok -- %d promotion(s) through the gauntlet, %d quarantined, "
        "0 captures after warmup" % (len(promoted),
                                     daemon.quarantined_count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
