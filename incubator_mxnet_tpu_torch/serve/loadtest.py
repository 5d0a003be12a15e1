"""Open-loop synthetic traffic for the serving stack (port of
``incubator_mxnet_tpu/serve/loadtest.py``).

Closed-loop load generators (send, wait, send) slow down exactly when
the server does and hide queueing collapse.  An **open-loop** generator
submits on its own clock, Poisson arrivals at a target rate like
independent users, so saturation shows where it belongs: in the latency
tail.

- Poisson arrivals: exponential inter-arrival gaps from a seeded
  ``numpy.random.RandomState`` (deterministic per seed);
- per-request latency from admission to completed scatter, reported as
  p50/p95/p99, and the sustained QPS over the window;
- the batcher's occupancy histogram and flush-trigger split (size or
  deadline);
- the engine's ``recompile_count`` delta over the window (on the card:
  CUDA-graph captures after warmup; must be 0);
- every future's terminal outcome: ok / engine error / SLO-expired /
  breaker-shed / **hung** (a future that did not resolve inside the
  collection bound; must be 0), the degraded-tier, retry, respawn and
  per-version counters, and the hot swaps (``promotions``) and
  rollbacks that landed under the window's traffic, with
  ``unattributed``: ok rows whose serving version cannot be named.

Every wait is bounded: a dead worker or a wedged engine turns into
``hung`` counts and a finite report, never a loadtest that blocks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from .batcher import Backpressure, ContinuousBatcher
from .resilience import classify_future

__all__ = ["LoadReport", "poisson_loadtest"]


@dataclass
class LoadReport:
    """One open-loop run's results (JSON-serializable via ``to_dict``)."""
    n_requests: int = 0
    ok: int = 0
    errors: int = 0
    shed: int = 0                  # Backpressure rejections at submit
    expired: int = 0               # SLO deadline passed (DeadlineExceeded)
    breaker_shed: int = 0          # dropped by the open circuit breaker
    hung: int = 0                  # futures that never resolved in bound
    degraded: int = 0              # requests served by the fallback tier
    retried: int = 0               # per-batch retry attempts
    respawns: int = 0              # watchdog worker respawns
    versions: Dict[str, int] = field(default_factory=dict)  # tier:vN -> rows
    unattributed: int = 0          # ok futures with NO version attribution
    promotions: int = 0            # engine swap_count delta in the window
    rollbacks: int = 0             # engine rollback_count delta (rejected
    #                                swaps rolled back under this traffic)
    wall_s: float = 0.0
    qps_offered: float = 0.0
    qps_sustained: float = 0.0
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    occupancy: Dict[int, int] = field(default_factory=dict)
    flush_full: int = 0
    flush_deadline: int = 0
    recompiles: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["occupancy"] = {str(k): v for k, v in self.occupancy.items()}
        return d

    def objective(self) -> float:
        """One scalar score for a measured serving policy (seconds, lower
        is better): the p99 latency, with a 1 s penalty per
        failed-service outcome (error / expired / hung / breaker-shed: a
        policy that drops work must never look "fast") and 100 ms per
        submit-shed request (offered load the queue refused)."""
        failures = self.errors + self.expired + self.hung \
            + self.breaker_shed
        return (self.p99_ms / 1e3) + 1.0 * failures + 0.1 * self.shed

    def format(self) -> str:
        occ = " ".join("%d:%d" % kv for kv in sorted(self.occupancy.items()))
        s = ("loadtest: %d req in %.2fs — %.1f qps sustained "
             "(%.1f offered), p50 %.2f / p95 %.2f / p99 %.2f ms, "
             "%d err, %d shed, occupancy {%s}, flushes %d full / %d "
             "deadline, %d recompiles"
             % (self.n_requests, self.wall_s, self.qps_sustained,
                self.qps_offered, self.p50_ms, self.p95_ms, self.p99_ms,
                self.errors, self.shed, occ, self.flush_full,
                self.flush_deadline, self.recompiles))
        if (self.expired or self.breaker_shed or self.hung
                or self.degraded or self.retried or self.respawns):
            s += (", %d expired, %d breaker-shed, %d hung, %d degraded, "
                  "%d retried, %d respawns"
                  % (self.expired, self.breaker_shed, self.hung,
                     self.degraded, self.retried, self.respawns))
        if self.versions:
            s += ", versions {%s}" % " ".join(
                "%s:%d" % kv for kv in sorted(self.versions.items()))
        if self.promotions or self.rollbacks or self.unattributed:
            # hot swaps and canary rollbacks that happened UNDER this
            # window's traffic, plus the exactly-one-version breach counter
            s += (", %d promotions, %d rollbacks, %d unattributed"
                  % (self.promotions, self.rollbacks, self.unattributed))
        return s


def poisson_loadtest(batcher: ContinuousBatcher,
                     payload_fn: Callable[[int, np.random.RandomState], Any],
                     qps: float, n_requests: int = 200, seed: int = 0,
                     timeout: float = 30.0,
                     deadline: Optional[float] = None,
                     priority: int = 0,
                     extra: Optional[Dict[str, Any]] = None) -> LoadReport:
    """Drive ``batcher`` with open-loop Poisson traffic.

    ``payload_fn(i, rng)`` builds the i-th request payload (one sample);
    ``qps`` is the offered rate — inter-arrival gaps are Exp(1/qps).
    ``deadline``/``priority`` ride every submit (the per-request SLO;
    ``None`` falls back to the batcher's ``default_deadline``).
    Submission never waits for completion (open loop; a full queue is
    recorded as shed load, not waited out), and collection is bounded
    by ``timeout``: a future that fails to resolve inside the bound is
    a ``hung`` count — the no-hang-invariant breach a chaos run exits
    1 on — never an indefinite block.  Returns a :class:`LoadReport`;
    the batcher's stats window is reset at start, so one batcher can
    serve several measured legs back to back.
    """
    if qps <= 0:
        raise ValueError("qps must be positive")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / qps, size=n_requests)
    batcher.stats.reset()
    recompiles0 = batcher.engine.recompile_count
    swaps0 = getattr(batcher.engine, "swap_count", 0)
    rollbacks0 = getattr(batcher.engine, "rollback_count", 0)
    futures = []
    shed = 0
    submit_errors = 0
    t0 = time.monotonic()
    next_t = t0
    for i in range(n_requests):
        next_t += gaps[i]
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            futures.append(batcher.submit(payload_fn(i, rng), block=False,
                                          deadline=deadline,
                                          priority=priority))
        except Backpressure:
            shed += 1
        except RuntimeError:
            # batcher broken mid-window (respawn budget spent under
            # chaos): the remaining offered load is an error, not a hang
            submit_errors += 1
    counts = {"ok": 0, "error": 0, "expired": 0, "shed": 0, "hung": 0}
    versions: Dict[str, int] = {}
    unattributed = 0
    hard_deadline = time.monotonic() + timeout
    for f in futures:
        outcome = classify_future(f, hard_deadline - time.monotonic())
        counts[outcome] += 1
        if outcome == "ok":
            tier = getattr(f, "_mxtpu_tier", None)
            ver = getattr(f, "_mxtpu_version", None)
            if tier is None or ver is None:
                # exactly-one-version breach: a served row whose version
                # cannot be named (chaos legs exit 1 on any of these)
                unattributed += 1
            else:
                key = "%s:v%s" % (tier, ver)
                versions[key] = versions.get(key, 0) + 1
    ok, errors = counts["ok"], counts["error"]
    expired, breaker_shed, hung = (counts["expired"], counts["shed"],
                                   counts["hung"])
    wall = time.monotonic() - t0
    pct = batcher.stats.percentiles()
    report = LoadReport(
        n_requests=n_requests, ok=ok, errors=errors + submit_errors,
        shed=shed,
        expired=expired, breaker_shed=breaker_shed, hung=hung,
        degraded=batcher.stats.degraded, retried=batcher.stats.retried,
        respawns=batcher.stats.respawns, versions=versions,
        unattributed=unattributed,
        promotions=getattr(batcher.engine, "swap_count", 0) - swaps0,
        rollbacks=getattr(batcher.engine, "rollback_count", 0)
        - rollbacks0,
        wall_s=wall, qps_offered=qps,
        qps_sustained=ok / wall if wall > 0 else 0.0,
        p50_ms=pct["p50"] * 1e3, p95_ms=pct["p95"] * 1e3,
        p99_ms=pct["p99"] * 1e3,
        occupancy=dict(batcher.stats.occupancy),
        flush_full=batcher.stats.flush_full,
        flush_deadline=batcher.stats.flush_deadline,
        recompiles=batcher.engine.recompile_count - recompiles0,
        extra=dict(extra or {}))
    return report
