#!/usr/bin/env python
"""Open-loop serving benchmark of the PyTorch/CUDA port: ServeEngine (one
CUDA graph per bucket) + ContinuousBatcher under Poisson traffic (port of
``tools/serve_bench.py``).

Prints, as JSON lines, per measured leg::

  {"metric": "serve_qps", "value": ..., "p50_ms": ..., "p99_ms": ...,
   "occupancy": {...}, "recompiles": 0, ...}

The fp32 leg always runs.  ``--int8`` adds the weight-only int8 tier on
the same traffic (same seed, same arrival process), so the latency delta
is the tier's (``serve_int8_p99_delta_ms``).  ``--chaos`` adds the
resilience leg: the same model behind a batcher with retry, a circuit
breaker and the int8 tier as its fallback engine, through the serving
fault hooks: a worker kill (the watchdog respawns it), an engine failure
burst (the breaker degrades to the int8 fallback and recovers), a
deadline storm (shed before compute) and a canaried hot swap with a
poisoned candidate (rolled back); then the swap storm:
``--storm-swaps`` back-to-back canaried swaps, one poisoned, under
sustained Poisson load, against a storm-free baseline of the same
traffic.

The run exits 1 on any capture after warmup (steady-state serving must
be capture-free), any future that did not resolve within its bound, a
poisoned swap that was accepted, a served row without exactly one
version, a storm p99 beyond the declared bound (baseline p99 * 10 + 250
ms) or a poisoned storm swap that did not leave the incumbent bitwise
unchanged.  It serves on the card unless ``--device cpu`` is given.

Examples::

  python tools/serve_bench_torch.py --model resnet50 --image-size 224 \\
      --buckets 16,64 --qps 400 --requests 200 --max-delay 10 --int8 --chaos
  python tools/serve_bench_torch.py --model mlp --device cpu --int8 --chaos
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T0 = time.time()


def log(msg):
    print("[serve_bench_torch %6.1fs] %s" % (time.time() - T0, msg),
          file=sys.stderr, flush=True)


def build_model(name, image_size, device=None):
    """``(net, sample_shape)``: the reference tool's models, Xavier from
    seed 0, their shapes resolved, on ``device``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context
    from incubator_mxnet_tpu_torch.gluon import nn

    mx.random.seed(0)
    with context.device_scope(device):
        if name == "mlp":
            net = nn.HybridSequential()
            net.add(nn.Dense(256, activation="relu"),
                    nn.Dense(256, activation="relu"), nn.Dense(64))
            shape = (128,)
        elif name == "cnn":
            net = nn.HybridSequential()
            net.add(nn.Conv2D(16, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.MaxPool2D(2),
                    nn.Conv2D(32, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.GlobalAvgPool2D(),
                    nn.Flatten(), nn.Dense(10))
            shape = (3, image_size, image_size)
        elif name == "resnet50":
            from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

            net = vision.resnet50_v1(classes=1000)
            shape = (3, image_size, image_size)
        else:
            raise SystemExit("unknown --model %r" % name)
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1,) + shape)
    return net, shape


def run_leg(tag, net, sample_shape, args, dtype=None, engine=None):
    """One measured leg: ``engine`` (warmed by this call), or a new engine
    of ``net`` in ``dtype``, behind a batcher under Poisson traffic.
    Prints the leg's JSON record; returns its ``LoadReport``."""
    import numpy as np

    from incubator_mxnet_tpu_torch.serve import (ContinuousBatcher,
                                                 ServeEngine,
                                                 poisson_loadtest)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    eng = engine or ServeEngine(net, buckets=buckets, dtype=dtype,
                                device=args.device)
    t = eng.warmup(np.zeros(sample_shape, np.float32))
    log("%s: warmed %d buckets (eager %.2fs, capture %.2fs)"
        % (tag, len(buckets), t["eager"], t["capture"]))
    rs = np.random.RandomState(args.seed)
    pool = rs.rand(64, *sample_shape).astype(np.float32)
    batcher = ContinuousBatcher(eng, max_delay=args.max_delay / 1e3,
                                max_queue=args.max_queue)
    try:
        rep = poisson_loadtest(batcher, lambda i, rng: pool[i % 64],
                               qps=args.qps, n_requests=args.requests,
                               seed=args.seed,
                               extra={"leg": tag, "model": args.model,
                                      "buckets": list(buckets)})
    finally:
        batcher.close()
    log(rep.format())
    rec = {"metric": "serve_qps", "value": round(rep.qps_sustained, 2),
           "unit": "req/s", "leg": tag, "model": args.model,
           "qps_offered": args.qps,
           "p50_ms": round(rep.p50_ms, 3), "p95_ms": round(rep.p95_ms, 3),
           "p99_ms": round(rep.p99_ms, 3),
           "ok": rep.ok, "errors": rep.errors, "shed": rep.shed,
           "hung": rep.hung,
           "occupancy": {str(k): v for k, v in
                         sorted(rep.occupancy.items())},
           "flush_full": rep.flush_full,
           "flush_deadline": rep.flush_deadline,
           "recompiles": rep.recompiles,
           "warmup_eager_s": round(t["eager"], 3),
           "warmup_capture_s": round(t["capture"], 3),
           "buckets": list(buckets), "max_delay_ms": args.max_delay}
    print(json.dumps(rec), flush=True)
    return rep


def int8_delta(rep, rep8):
    """Print and return ``serve_int8_p99_delta_ms``: the int8 leg's p99
    less the fp32 leg's on the same traffic."""
    delta = rep8.p99_ms - rep.p99_ms
    print(json.dumps({"metric": "serve_int8_p99_delta_ms",
                      "value": round(delta, 3), "unit": "ms",
                      "fp32_p99_ms": round(rep.p99_ms, 3),
                      "int8_p99_ms": round(rep8.p99_ms, 3)}), flush=True)
    return delta


def run_chaos(net, sample_shape, args):
    """The resilience leg: the chaos scenarios against a breaker and
    fallback batcher.  Returns the number of failures (hung futures,
    captures after warmup, an accepted poisoned swap): 0 is the
    contract."""
    import numpy as np

    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.serve import (CircuitBreaker,
                                                 ContinuousBatcher,
                                                 RetryPolicy, ServeEngine,
                                                 SwapRejected)
    from incubator_mxnet_tpu_torch.serve.resilience import classify_future

    buckets = tuple(int(b) for b in args.buckets.split(","))
    eng = ServeEngine(net, buckets=buckets, device=args.device)
    eng.warmup(np.zeros(sample_shape, np.float32))
    fb = ServeEngine(net, buckets=buckets, dtype="int8",
                     device=args.device)
    fb.warmup(np.zeros(sample_shape, np.float32))
    recompiles0 = eng.recompile_count + fb.recompile_count
    rs = np.random.RandomState(args.seed)
    pool = rs.rand(64, *sample_shape).astype(np.float32)
    batcher = ContinuousBatcher(
        eng, max_delay=args.max_delay / 1e3, max_queue=args.max_queue,
        retry=RetryPolicy(max_retries=1, backoff=0.002),
        breaker=CircuitBreaker(failure_threshold=3, recovery_time=0.1),
        fallback=fb, grace=0.05)
    counts = {"ok": 0, "error": 0, "expired": 0, "shed": 0, "hung": 0,
              "degraded": 0}
    poison_accepted = False

    def drain(futures, bound=15.0):
        end = time.monotonic() + bound
        for f in futures:
            outcome = classify_future(f, end - time.monotonic())
            counts[outcome] += 1
            if outcome == "ok" and \
                    getattr(f, "_mxtpu_tier", None) == "fallback":
                counts["degraded"] += 1

    try:
        # 1. worker kill mid-traffic: the watchdog fails the lost batch
        # and respawns; later traffic serves again
        with fi.kill_batcher_worker(at=0):
            drain([batcher.submit(pool[i % 64]) for i in range(8)])
        log("chaos: worker kill -- respawns=%d worker_deaths=%d"
            % (batcher.stats.respawns, batcher.stats.worker_deaths))
        # 2. failure burst on the primary only: retry absorbs the head,
        # the breaker opens onto the int8 tier, then half-opens and
        # recovers
        with fi.engine_failure_burst(8, engine=eng):
            drain([batcher.submit(pool[i % 64]) for i in range(12)])
        time.sleep(0.15)  # past recovery_time: the next batch probes
        drain([batcher.submit(pool[0])])
        log("chaos: failure burst -- breaker=%s degraded=%d retried=%d"
            % (batcher.breaker.state, batcher.stats.degraded,
               batcher.stats.retried))
        # 3. deadline storm: dead work shed before compute
        futs, _ = fi.deadline_storm(batcher, [pool[0]] * 16, deadline=1e-4)
        drain(futs)
        log("chaos: deadline storm -- expired=%d" % batcher.stats.expired)
        # 4. canaried hot swap: a candidate commits with no capture; a
        # poisoned one rolls back with the old version serving
        v = eng.update_params([p.data().asnumpy() for p in eng._params])
        try:
            eng.update_params(fi.nan_params(eng))
            log("chaos: FAIL -- poisoned swap was accepted")
            poison_accepted = True
        except SwapRejected:
            pass
        drain([batcher.submit(pool[i % 64]) for i in range(4)])
        log("chaos: hot swap -- version=%d rollbacks=%d"
            % (v, eng.rollback_count))
    finally:
        batcher.close()
    recompiles = (eng.recompile_count + fb.recompile_count) - recompiles0
    hung = counts["hung"]
    rec = {"metric": "serve_chaos", "value": hung, "unit": "hung_futures",
           "served": counts["ok"], "failed": counts["error"],
           "expired": counts["expired"], "breaker_shed": counts["shed"],
           "degraded": counts["degraded"],
           "retried": batcher.stats.retried,
           "respawns": batcher.stats.respawns,
           "worker_deaths": batcher.stats.worker_deaths,
           "breaker_state": batcher.breaker.state,
           "swap_version": eng.params_version,
           "rollbacks": eng.rollback_count,
           "poison_accepted": poison_accepted,
           "recompiles": recompiles}
    print(json.dumps(rec), flush=True)
    if hung or recompiles or poison_accepted:
        log("chaos: FAIL -- %d hung future(s), %d capture(s) after "
            "warmup, poison_accepted=%s" % (hung, recompiles,
                                            poison_accepted))
        return 1
    log("chaos: ok -- every future resolved, 0 captures after warmup")
    return 0


def run_swap_storm(net, sample_shape, args):
    """The flywheel chaos leg: ``--storm-swaps`` back-to-back canaried hot
    swaps, one of them poisoned, under sustained Poisson load, against a
    storm-free baseline of the same traffic (same seed, same arrival
    process).  Returns the number of failures: captures after warmup,
    hung futures, rows without exactly one version, a p99 beyond the
    declared bound, or a poisoned swap accepted or not leaving the
    incumbent bitwise unchanged."""
    import numpy as np

    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.serve import (ContinuousBatcher,
                                                 ServeEngine,
                                                 poisson_loadtest)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    eng = ServeEngine(net, buckets=buckets, device=args.device)
    eng.warmup(np.zeros(sample_shape, np.float32))
    recompiles0 = eng.recompile_count
    rs = np.random.RandomState(args.seed)
    pool = rs.rand(64, *sample_shape).astype(np.float32)
    batcher = ContinuousBatcher(eng, max_delay=args.max_delay / 1e3,
                                max_queue=args.max_queue)
    try:
        base = poisson_loadtest(batcher, lambda i, rng: pool[i % 64],
                                qps=args.qps, n_requests=args.requests,
                                seed=args.seed,
                                extra={"leg": "storm_baseline"})
        log("storm baseline: " + base.format())
        with fi.swap_storm(eng, n_swaps=args.storm_swaps, interval=0.02,
                           poison_at=args.storm_swaps // 2,
                           seed=args.seed) as st:
            storm = poisson_loadtest(batcher, lambda i, rng: pool[i % 64],
                                     qps=args.qps, n_requests=args.requests,
                                     seed=args.seed,
                                     extra={"leg": "swap_storm"})
        log("swap storm:     " + storm.format())
    finally:
        batcher.close()
    # the reference's declared bound: generous against the host's speed
    # spread; the claim is that a storm does not blow up the tail
    bound_ms = base.p99_ms * 10.0 + 250.0
    recompiles = eng.recompile_count - recompiles0
    checks = [
        (recompiles, "%d capture(s) after warmup" % recompiles),
        (base.hung or storm.hung, "hung futures (baseline %d, storm %d)"
         % (base.hung, storm.hung)),
        (storm.unattributed or base.unattributed,
         "%d row(s) without exactly one version"
         % (storm.unattributed + base.unattributed)),
        (storm.p99_ms > bound_ms, "p99 %.2fms beyond the declared bound "
         "%.2fms (baseline %.2fms)" % (storm.p99_ms, bound_ms, base.p99_ms)),
        (st.error or not st.poison_rejected or not st.incumbent_bitwise_ok,
         "storm error=%r poison_rejected=%s incumbent_bitwise_ok=%s"
         % (st.error, st.poison_rejected, st.incumbent_bitwise_ok)),
        (not st.committed, "0 swaps landed, nothing stress-tested"),
    ]
    failures = 0
    for bad, what in checks:
        if bad:
            log("swap storm: FAIL -- " + what)
            failures += 1
    rec = {"metric": "serve_swap_storm",
           "value": round(storm.p99_ms - base.p99_ms, 3), "unit": "ms",
           "baseline_p99_ms": round(base.p99_ms, 3),
           "storm_p99_ms": round(storm.p99_ms, 3),
           "bound_ms": round(bound_ms, 3),
           "swaps_attempted": st.attempted, "swaps_committed": st.committed,
           "promotions": storm.promotions, "rollbacks": storm.rollbacks,
           "versions": storm.versions, "unattributed": storm.unattributed,
           "hung": base.hung + storm.hung, "recompiles": recompiles,
           "poison_rejected": bool(st.poison_rejected),
           "incumbent_bitwise_ok": bool(st.incumbent_bitwise_ok),
           "storm_error": st.error}
    print(json.dumps(rec), flush=True)
    if not failures:
        log("swap storm: ok -- %d promotions under load, p99 delta %.2fms "
            "within bound, 0 captures after warmup, incumbent restored "
            "bitwise on poison" % (st.committed,
                                   storm.p99_ms - base.p99_ms))
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="mlp",
                    choices=["mlp", "cnn", "resnet50"])
    ap.add_argument("--buckets", default="8,32",
                    help="comma-separated batch buckets (default 8,32)")
    ap.add_argument("--qps", type=float, default=500.0,
                    help="offered open-loop rate (Poisson)")
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--max-delay", type=float, default=5.0,
                    help="batcher deadline, milliseconds")
    ap.add_argument("--max-queue", type=int, default=1024)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--int8", action="store_true",
                    help="add the weight-only int8 leg (same traffic)")
    ap.add_argument("--chaos", action="store_true",
                    help="add the resilience legs (worker kill, failure "
                         "burst, deadline storm, hot swap, swap storm under "
                         "load); exit 1 on any hung future, capture after "
                         "warmup, unattributed row or accepted poisoned "
                         "swap")
    ap.add_argument("--storm-swaps", type=int, default=6,
                    help="swap storm leg: swaps fired under load (one of "
                         "them poisoned; default 6)")
    ap.add_argument("--device", default=None,
                    help="where to serve (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from incubator_mxnet_tpu_torch import context

    device = context.resolve(args.device)
    log("device: %s%s" % (device, " (%s)" % torch.cuda.get_device_name(
        device) if device.type == "cuda" else ""))
    net, sample_shape = build_model(args.model, args.image_size, device)
    rep = run_leg("fp32", net, sample_shape, args)
    bad = rep.recompiles + rep.hung
    if args.int8:
        rep8 = run_leg("int8", net, sample_shape, args, dtype="int8")
        bad += rep8.recompiles + rep8.hung
        int8_delta(rep, rep8)
    if args.chaos:
        bad += run_chaos(net, sample_shape, args)
        bad += run_swap_storm(net, sample_shape, args)
    if bad:
        log("FAIL: %d capture(s) after warmup / hung future(s) / chaos "
            "failure(s) -- steady-state serving must be capture-free and "
            "hang-free" % bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
