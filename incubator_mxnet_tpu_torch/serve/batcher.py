"""Continuous batcher: an async request queue in front of a ServeEngine
(port of ``incubator_mxnet_tpu/serve/batcher.py``).

The throughput of a bucketed engine comes from batch occupancy; the
latency of an interactive service comes from NOT waiting for full
batches.  The continuous batcher holds both ends:

- requests enter a **bounded** queue (full surfaces as
  :class:`Backpressure`) with an admission timestamp and an optional
  **SLO deadline** (``submit(deadline=)``): work that has already expired
  is shed *before* compute (:class:`~.resilience.DeadlineExceeded`), and
  the watchdog reaper resolves the future by deadline+epsilon even when
  the engine itself hangs;
- one worker thread assembles flushes, triggered by **size** (the batch
  reached ``max_batch``), by **flush deadline** (the oldest admitted
  request has waited ``max_delay``), or by the tightest member's SLO
  deadline;
- a malformed request (wrong shape/dtype, unconvertible payload) fails
  on its own future with :class:`RequestError`; its batch, the worker
  and the queue go on (``parallel/fault_injection.py``
  ``malformed_request``);
- the worker is **watched**: a worker that died silently (a
  ``BaseException`` out of the engine) is respawned at most
  ``max_respawns`` times, its lost batch failed loudly; past the budget
  everything pending fails and submits are refused;
- engine failures are **retried** per batch (``retry=``,
  :class:`~.resilience.RetryPolicy`) and **counted** by the circuit
  breaker (``breaker=``, :class:`~.resilience.CircuitBreaker`): an open
  breaker degrades to the ``fallback=`` engine when one is given, else to
  priority-aware shedding (:class:`~.resilience.Shed` for ``priority <=
  0``), and half-opens after a cooldown to probe recovery;
- ``close()`` refuses new submits, the worker drains and serves what is
  queued, the join is bounded and warns on timeout, and any request
  still unserved after it fails on its future.

A batch's outputs come back to the host in one transfer per tensor and
each future resolves to its row as a numpy array (a bfloat16 output as
float32, which holds it exactly: numpy has no bfloat16 of its own).

Submissions pass through the module-level :func:`_admit` hook and every
engine execution through :func:`_serve_batch`, so the fault harness can
interpose request- and engine-level scenarios (``slow_client``,
``kill_batcher_worker``, ``engine_failure_burst``) without touching the
batcher's internals.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import Counter
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .engine import tree_map
from .resilience import CircuitBreaker, DeadlineExceeded, RetryPolicy, Shed

__all__ = ["Backpressure", "ContinuousBatcher", "RequestError",
           "ServeStats"]

#: worker poll period while waiting for the first request of a batch
_POLL = 0.01
#: watchdog poll period: worker-liveness probe + deadline reaper tick —
#: the ε in the "every future resolves by deadline+ε" guarantee is
#: ``grace`` + one tick of this
_WATCHDOG_POLL = 0.005


class Backpressure(RuntimeError):
    """The bounded request queue is full — the service is overloaded;
    shed or retry with backoff."""


class RequestError(ValueError):
    """This request was rejected (malformed payload); the batch it
    arrived with was served normally."""


def _admit(req):
    """Admission choke point for every submitted request.  Module-level
    so the fault harness (``parallel/fault_injection.py::slow_client``)
    can interpose latency/faults without touching internals."""
    return req


def _serve_batch(engine, xv):
    """Engine-execution choke point for every flushed batch.  Module-
    level so the fault harness (``kill_batcher_worker``,
    ``engine_failure_burst``) can interpose worker death and engine
    faults without touching internals — the serving analog of
    ``io/resilient.py::_pull``."""
    return engine.infer(xv)


def _host(a):
    """One output tensor as a host numpy array (bfloat16 as float32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _fail(fut: Future, exc: BaseException) -> bool:
    """Set ``exc`` on ``fut`` unless it already resolved.  Worker,
    watchdog reaper and ``close()`` race to resolve the same futures;
    first writer wins, everyone else no-ops (returns False)."""
    if fut.done():
        return False
    try:
        fut.set_exception(exc)
        return True
    except InvalidStateError:  # lost the race after the done() check
        return False


def _resolve(fut: Future, value) -> bool:
    """Set ``value`` on ``fut`` unless it already resolved (e.g. the
    reaper expired it while the batch was on device)."""
    if fut.done():
        return False
    try:
        fut.set_result(value)
        return True
    except InvalidStateError:
        return False


class _Request:
    __slots__ = ("payload", "future", "t_submit", "t_deadline", "priority")

    def __init__(self, payload, future, t_submit, t_deadline=None,
                 priority=0):
        self.payload = payload
        self.future = future
        self.t_submit = t_submit
        self.t_deadline = t_deadline   # absolute monotonic, or None
        self.priority = priority


class ServeStats:
    """Rolling serving statistics (reset between loadtest windows).

    ``window`` bounds the latency record — a long-lived server appends
    one float per request, so an unbounded list would be a slow leak;
    percentiles are computed over the most recent ``window`` requests.
    """

    def __init__(self, window: int = 65536):
        self._window = int(window)
        self._lock = threading.Lock()
        self.reset()

    def inc(self, name: str, n: int = 1):
        """Race-safe increment for the counters bumped from more than
        one thread (worker, watchdog reaper, submitting callers) —
        ``+=`` on an attribute is load/add/store and drops increments
        under a GIL switch.  Single-writer counters keep plain ``+=``.
        """
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def reset(self):
        from collections import deque

        self.latencies = deque(maxlen=self._window)
        self.occupancy: Counter = Counter()   # rows actually served
        self.flush_full = 0                   # size-triggered flushes
        self.flush_deadline = 0               # deadline-triggered flushes
        self.flush_drain = 0                  # shutdown-drain flushes
        self.rejected = 0                     # malformed requests
        self.failed = 0                       # requests failed by engine errors
        self.expired = 0                      # SLO deadline passed (shed/reaped)
        self.breaker_shed = 0                 # dropped by the open breaker
        self.degraded = 0                     # served by the fallback tier
        self.retried = 0                      # per-batch retry attempts
        self.worker_deaths = 0                # watchdog-observed deaths
        self.respawns = 0                     # watchdog respawns (this window)
        self.versions: Counter = Counter()    # (tier, param version) -> rows

    def percentiles(self, qs=(50, 95, 99)) -> Dict[str, float]:
        if not self.latencies:
            return {"p%d" % q: float("nan") for q in qs}
        arr = np.asarray(self.latencies)
        return {"p%d" % q: float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> Dict[str, Any]:
        out = {"served": len(self.latencies),
               "rejected": self.rejected, "failed": self.failed,
               "expired": self.expired,
               "breaker_shed": self.breaker_shed,
               "degraded": self.degraded, "retried": self.retried,
               "worker_deaths": self.worker_deaths,
               "respawns": self.respawns,
               "versions": {"%s:v%s" % tv: n
                            for tv, n in sorted(self.versions.items())},
               "flush_full": self.flush_full,
               "flush_deadline": self.flush_deadline,
               "flush_drain": self.flush_drain,
               "occupancy": dict(sorted(self.occupancy.items()))}
        out.update({k: v * 1e3 for k, v in self.percentiles().items()})
        return out


class ContinuousBatcher:
    """Dynamic batcher over a warmed :class:`~.engine.ServeEngine`.

    ``max_batch`` defaults to the engine's largest bucket; ``max_delay``
    (seconds) bounds how long an admitted request may wait for
    batchmates; ``max_queue`` bounds admission (``Backpressure``) —
    counted over admitted-but-UNRESOLVED requests, so an expired/reaped
    request frees its slot immediately (backpressure reflects live
    work, never tombstones a wedged worker has not drained).

    Resilience knobs:

    - ``default_deadline`` — SLO seconds applied to every submit that
      does not pass its own ``deadline=``; ``None`` (default) means no
      SLO (the request waits as long as the service needs);
    - ``grace`` — the reaper's ε: an unresolved request is failed with
      ``DeadlineExceeded`` at most ``deadline + grace + one watchdog
      tick`` after submission, even if the engine is wedged;
    - ``retry`` — a :class:`~.resilience.RetryPolicy`; ``None``
      (default) fails a batch on the first engine error (the
      pre-resilience behavior);
    - ``breaker`` — a :class:`~.resilience.CircuitBreaker`; ``None``
      (default) means engine failures fail their batch but never trip
      routing;
    - ``fallback`` — a second warmed engine (a cheaper tier, such as a
      ``dtype="bfloat16"`` engine) serving the
      SAME sample signature, used while the breaker is open (and as
      immediate failover for a batch the primary just failed);
    - ``max_respawns`` — the watchdog's respawn budget for a silently
      died worker; past it the batcher is broken: everything pending
      fails and ``submit`` raises.
    """

    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_delay: float = 0.005, max_queue: int = 1024,
                 default_deadline: Optional[float] = None,
                 grace: float = 0.05,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 fallback=None, max_respawns: int = 3):
        if engine.sample_shape is None:
            raise ValueError("warmup() the engine before attaching a "
                             "batcher (it pins the request signature "
                             "submits are validated against)")
        if max_delay <= 0:
            raise ValueError("max_delay must be positive seconds")
        self.engine = engine
        self.max_batch = int(max_batch or engine.max_bucket)
        if self.max_batch < 1 or self.max_batch > engine.max_bucket:
            raise ValueError("max_batch must be in [1, %d] (the engine's "
                             "largest bucket), got %d"
                             % (engine.max_bucket, self.max_batch))
        self.max_delay = float(max_delay)
        if int(max_queue) < 1:
            # queue.Queue(0) is UNBOUNDED in the stdlib — the opposite
            # of the backpressure contract this class promises
            raise ValueError("max_queue must be >= 1 (a bounded queue is "
                             "the backpressure mechanism), got %r"
                             % (max_queue,))
        if default_deadline is not None and float(default_deadline) <= 0:
            raise ValueError("default_deadline must be positive seconds "
                             "(or None for no SLO), got %r"
                             % (default_deadline,))
        if float(grace) < 0:
            raise ValueError("grace must be >= 0 seconds, got %r"
                             % (grace,))
        if fallback is not None:
            if fallback.sample_shape is None:
                raise ValueError("warmup() the fallback engine before "
                                 "attaching it (the degraded tier must "
                                 "be compile-free too)")
            if (fallback.sample_shape != engine.sample_shape
                    or fallback.sample_dtype != engine.sample_dtype):
                raise ValueError(
                    "fallback engine serves %s/%s but the primary serves "
                    "%s/%s — both tiers must accept the same requests"
                    % (fallback.sample_shape, fallback.sample_dtype,
                       engine.sample_shape, engine.sample_dtype))
        if int(max_respawns) < 0:
            raise ValueError("max_respawns must be >= 0, got %r"
                             % (max_respawns,))
        self.default_deadline = (None if default_deadline is None
                                 else float(default_deadline))
        self.grace = float(grace)
        self.retry = retry
        self.breaker = breaker
        self.fallback = fallback
        self.max_respawns = int(max_respawns)
        self.stats = ServeStats()
        self.max_queue = int(max_queue)
        # admission is bounded on OUTSTANDING UNRESOLVED requests (the
        # pending registry) so a reaped request's tombstone — still
        # enqueued until the worker discards it — never eats capacity or
        # wedges a blocking submit (backpressure on live work, not on
        # corpses).  The wire queue carries live + tombstones and is
        # capped at 2x max_queue as the memory backstop: a wedged worker
        # under reap-and-resubmit churn cannot ramp payloads unboundedly
        self._q_cap = 2 * self.max_queue
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._broken: Optional[str] = None   # respawn budget exhausted
        self._respawns = 0                   # lifetime budget (stats reset)
        self._inflight: Optional[List[_Request]] = None
        self._pending: set = set()           # admitted, unresolved requests
        self._plock = threading.Lock()
        self._spawn_worker()
        self._watchdog = threading.Thread(target=self._watch,
                                          name="serve-watchdog", daemon=True)
        self._watchdog.start()

    def _spawn_worker(self):
        t = threading.Thread(target=self._worker,
                             name="serve-batcher", daemon=True)
        # start BEFORE publishing: close()/submit read self._thread from
        # other threads, and joining a created-but-unstarted thread raises
        t.start()
        self._thread = t

    # ------------------------------------------------------------------
    def submit(self, payload, block: bool = True,
               timeout: Optional[float] = None,
               deadline: Optional[float] = None,
               priority: int = 0) -> Future:
        """Enqueue one request (a single sample, no batch dim); returns
        a ``concurrent.futures.Future`` resolving to its output row.

        ``deadline`` is this request's SLO budget in seconds from now
        (``None`` falls back to the batcher's ``default_deadline``): if
        it expires before compute the request is shed with
        :class:`~.resilience.DeadlineExceeded` — never served dead —
        and in every case the future resolves by deadline+ε (the reaper
        backstop).  ``priority`` matters only under breaker shedding:
        requests with ``priority > 0`` are still attempted on the
        primary while ``<= 0`` are shed.

        Raises :class:`Backpressure` when ``max_queue`` requests are
        already admitted and unresolved (``block=False``, or ``timeout``
        elapsed while waiting for a slot) and ``RuntimeError`` after
        ``close()`` or once the worker respawn budget is spent — a
        blocking submit re-checks both every tick, so shutdown wakes it.
        """
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        if self._broken:
            raise RuntimeError("batcher is broken: %s" % self._broken)
        d = self.default_deadline if deadline is None else float(deadline)
        if d is not None and d <= 0:
            raise ValueError("deadline must be positive seconds (the SLO "
                             "budget from now), got %r" % (deadline,))
        fut: Future = Future()
        t_sub = time.monotonic()
        req = _admit(_Request(payload, fut, t_sub,
                              None if d is None else t_sub + d,
                              int(priority)))
        # admission control: one slot per admitted-but-unresolved
        # request.  check-and-reserve is atomic under the pending lock;
        # a blocking submit waits in bounded ticks, re-checking stop/
        # broken each round, so close() or a broken batcher wakes it —
        # and capacity frees the moment ANY resolution (worker, reaper,
        # close) lands, not when the worker drains the tombstone
        t_give_up = None if timeout is None else t_sub + float(timeout)
        while True:
            with self._plock:
                if len(self._pending) < self.max_queue and \
                        self._q.qsize() < self._q_cap:
                    self._pending.add(req)
                    break
            if not block or \
                    (t_give_up is not None
                     and time.monotonic() >= t_give_up):
                raise Backpressure(
                    "request queue full (%d unresolved) — the service is "
                    "saturated; shed load or retry with backoff"
                    % len(self._pending)) from None
            if req.t_deadline is not None and \
                    time.monotonic() >= req.t_deadline:
                # the SLO expired while waiting for admission — the
                # budget covers admission latency, and failing here is
                # what keeps a blocking submit bounded even when the
                # wire-queue cap (not the pending count) is the limiter
                if _fail(fut, DeadlineExceeded(
                        "SLO deadline expired while waiting for "
                        "admission — the service is saturated")):
                    self.stats.inc("expired")
                return fut
            if self._stop.wait(_POLL) or self._broken:
                raise RuntimeError(
                    "batcher is closed" if self._stop.is_set()
                    else "batcher is broken: %s" % self._broken)
        # registered: from this moment the reaper owns the no-hang
        # guarantee for this request
        fut.add_done_callback(lambda _f, r=req: self._discard_pending(r))
        self._q.put(req)  # unbounded wire queue: never blocks
        # close-race seal: a submit that passed the stop check before
        # close() set the flag can land its put after the worker is
        # gone.  If that happened, nobody will ever serve the queue —
        # fail it (including our own request) instead of hanging the
        # caller's future.result() forever.  While the worker is still
        # alive its stop-drain loop serves everything queued, and
        # close()'s post-join drain covers anything it left behind.
        if self._stop.is_set() and not self._thread.is_alive():
            self._fail_queued()
        # same seal for the broken transition: a submit that passed the
        # broken check before the watchdog spent the respawn budget can
        # land after its one-shot cleanup — nobody will ever serve it
        if self._broken:
            self._fail_queued("batcher is broken: %s" % self._broken)
            self._fail_pending("batcher is broken: %s" % self._broken)
        return fut

    def _discard_pending(self, req):
        with self._plock:
            self._pending.discard(req)

    # ------------------------------------------------------------------
    def _gather(self) -> Optional[List[_Request]]:
        """Block for the first request, then fill until ``max_batch``
        rows or the flush deadline — the oldest member's ``max_delay``
        wait or the tightest member's SLO deadline, whichever is first.
        Returns None when stopped and drained."""
        while True:
            try:
                first = self._q.get(timeout=_POLL)
                if first.future.done():
                    continue  # tombstone (reaped) — never burn a slot
                break
            except queue.Empty:
                if self._stop.is_set():
                    return None
        batch = [first]
        flush_at = first.t_submit + self.max_delay
        flush_at = min(flush_at, self._slo_cap(first))
        while len(batch) < self.max_batch:
            rem = flush_at - time.monotonic()
            if rem <= 0:
                # deadline hit: scoop everything already queued (a
                # backlogged worker must not degrade to batches of 1 —
                # the whole point of CONTINUOUS batching), then flush
                while len(batch) < self.max_batch:
                    try:
                        r = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if not r.future.done():
                        batch.append(r)
                self.stats.flush_deadline += 1
                return batch
            if self._stop.is_set():
                # draining: serve everything immediately-available, but
                # never sit out a deadline nobody else will feed (its
                # own stat — a drain flush is not deadline pressure)
                try:
                    r = self._q.get_nowait()
                    if not r.future.done():
                        batch.append(r)
                    continue
                except queue.Empty:
                    self.stats.flush_drain += 1
                    return batch
            try:
                r = self._q.get(timeout=min(rem, _POLL))
            except queue.Empty:
                continue
            if r.future.done():
                continue  # tombstone — keep the slot for live work
            batch.append(r)
            flush_at = min(flush_at, self._slo_cap(r))
        self.stats.flush_full += 1
        return batch

    def _slo_cap(self, r) -> float:
        """The latest moment ``r`` may wait for batchmates: its SLO
        deadline MINUS a service margin — flushing *at* the deadline
        would guarantee the shed-before-compute check kills it.  The
        margin is ``grace`` capped at half the request's own budget, so
        a tight-SLO request on an idle engine still flushes early
        enough to be served in budget, while an already-expired one
        (a deadline storm) flushes immediately and is shed."""
        if r.t_deadline is None:
            return float("inf")
        budget = r.t_deadline - r.t_submit
        return r.t_deadline - min(self.grace, budget * 0.5)

    # ------------------------------------------------------------------
    def _route(self) -> str:
        """Breaker-policy routing for the next batch: ``"primary"``
        (healthy or half-open probe) or ``"degraded"`` (fallback tier /
        shedding)."""
        if self.breaker is None:
            return "primary"
        return "primary" if self.breaker.route() in ("serve", "probe") \
            else "degraded"

    def _serve_with_retry(self, engine, xv, reqs):
        """One tier's execution: ``_serve_batch`` + host transfer, with
        the batcher's retry policy applied to transient failures —
        bounded attempts, exponential backoff, never sleeping past the
        batch's tightest SLO deadline or through a stop."""
        attempt = 0
        while True:
            try:
                out = _serve_batch(engine, xv)
                # ONE transfer for the whole batch, then host-side
                # scatter
                return tree_map(_host, out)
            except Exception as e:  # noqa: BLE001 — classified below
                pol = self.retry
                if pol is None or not pol.is_transient(e) \
                        or attempt >= pol.max_retries:
                    raise
                delay = pol.delay(attempt)
                tightest = min((r.t_deadline for r in reqs
                                if r.t_deadline is not None), default=None)
                if tightest is not None and \
                        time.monotonic() + delay >= tightest:
                    # the backoff alone would blow the SLO: fail fast so
                    # the deadline machinery sheds instead of serving dead
                    raise
                attempt += 1
                self.stats.retried += 1
                if self._stop.wait(delay):
                    raise

    def _flush(self, reqs: List[_Request]):
        eng = self.engine
        now = time.monotonic()
        rows, good = [], []
        for r in reqs:
            if r.future.done():
                continue  # the reaper got there first
            if r.t_deadline is not None and now >= r.t_deadline:
                # shed BEFORE compute: a request that expired in the
                # queue must never burn a bucket slot being served dead
                if _fail(r.future, DeadlineExceeded(
                        "request expired in queue %.1f ms past its SLO "
                        "deadline — shed before compute"
                        % ((now - r.t_deadline) * 1e3))):
                    self.stats.inc("expired")
                continue
            try:
                a = np.asarray(r.payload)
                if tuple(a.shape) != eng.sample_shape:
                    raise ValueError(
                        "request shape %s, engine serves %s"
                        % (tuple(a.shape), eng.sample_shape))
                a = np.ascontiguousarray(a, dtype=eng.sample_dtype)
            except Exception as e:  # noqa: BLE001 — per-request isolation
                self.stats.rejected += 1
                _fail(r.future, RequestError(
                    "malformed request: %s: %s" % (type(e).__name__, e)))
                continue
            rows.append(a)
            good.append(r)
        if not good:
            return
        route = self._route()
        if route == "degraded" and self.fallback is None:
            # priority-aware shedding: the breaker is open and there is
            # no degraded tier — shed the batch cheaply, except that
            # higher-priority requests still try the primary (their
            # outcome doubles as a recovery probe)
            keep_rows, keep = [], []
            for a, r in zip(rows, good):
                if r.priority > 0:
                    keep_rows.append(a)
                    keep.append(r)
                elif _fail(r.future, Shed(
                        "circuit breaker open (%d consecutive engine "
                        "failures) and no fallback tier loaded — request "
                        "shed; retry with backoff or raise priority"
                        % self.breaker.consecutive_failures)):
                    self.stats.breaker_shed += 1
            if not keep:
                return
            rows, good = keep_rows, keep
            route = "primary"
        xv = np.stack(rows)
        out, tier, served = None, None, None
        if route == "primary":
            try:
                out = self._serve_with_retry(eng, xv, good)
                tier, served = "primary", eng
                if self.breaker is not None:
                    self.breaker.record_success()
            except Exception as e:  # noqa: BLE001 — degrade, then fail
                if self.breaker is not None:
                    self.breaker.record_failure()
                if self.fallback is None:
                    self.stats.inc("failed", len(good))
                    for r in good:
                        _fail(r.future, e)
                    return
                route = "degraded"  # immediate failover for THIS batch
        if route == "degraded":
            try:
                out = self._serve_with_retry(self.fallback, xv, good)
                tier, served = "fallback", self.fallback
            except Exception as e:  # noqa: BLE001 — both tiers down
                self.stats.inc("failed", len(good))
                for r in good:
                    _fail(r.future, e)
                return
        # attribution: the engine records which param version produced
        # this batch (exactly one — infer snapshots the live version
        # once per call, so a hot swap never splits a batch).  Counted
        # per DELIVERED response (like latencies): a row whose future
        # the reaper already expired is 'expired', not 'served by vN'
        ver = getattr(served, "last_version_served", None)
        t_done = time.monotonic()
        self.stats.occupancy[len(good)] += 1
        for i, r in enumerate(good):
            r.future._mxtpu_tier = tier
            r.future._mxtpu_version = ver
            if _resolve(r.future, tree_map(lambda a: a[i], out)):
                self.stats.latencies.append(t_done - r.t_submit)
                self.stats.versions[(tier, ver)] += 1
                if tier == "fallback":
                    self.stats.degraded += 1

    def _worker(self):
        while True:
            batch = self._gather()
            if batch is None:
                return
            # published for the watchdog: if a BaseException kills this
            # thread mid-flush, the respawn fails these futures instead
            # of leaking them (a popped batch is in nobody's queue)
            self._inflight = batch
            try:
                self._flush(batch)
            except Exception as e:  # noqa: BLE001 — the loop must survive
                for r in batch:
                    _fail(r.future, e)
            self._inflight = None

    # ------------------------------------------------------------------
    def _watch(self):
        """Watchdog thread: worker-liveness probe with bounded respawn
        (the ``ResilientIter`` discipline applied to ``_worker``) plus
        the SLO deadline reaper — the enforcement backstop that makes
        "every future resolves by deadline+ε" true even when the engine
        itself hangs."""
        while not self._stop.is_set():
            if self._stop.wait(_WATCHDOG_POLL):
                break
            try:
                self._watch_once()
            except Exception:  # noqa: BLE001 — the backstop must survive
                # the watchdog IS the no-hang guarantee: an exception
                # here (thread-limit respawn failure, warnings-as-errors)
                # must not kill the reaper.  Contain, fail what we can,
                # keep ticking.
                try:
                    if self._broken:
                        self._fail_queued("batcher is broken: %s"
                                          % self._broken)
                        self._fail_pending("batcher is broken: %s"
                                           % self._broken)
                except Exception:  # noqa: BLE001 — best effort
                    pass

    def _watch_once(self):
        # --- liveness: a dead worker (BaseException out of the
        # engine — SystemExit from a fault, a C-extension abort)
        # never reports its batch; fail it, then respawn within budget
        if self._broken is None and not self._thread.is_alive():
            lost, self._inflight = self._inflight, None
            if self._stop.is_set():
                # shutting down: a drained worker exiting cleanly is
                # not a death; close() fails whatever is left, and a
                # respawn here would only race its join
                self._fail_lost(lost)
                return
            self.stats.worker_deaths += 1
            if self._respawns >= self.max_respawns:
                self._broken = ("worker died %d times (max_respawns="
                                "%d spent)" % (self._respawns + 1,
                                               self.max_respawns))
                # fail everything FIRST — warn() can raise under a
                # warnings-as-errors filter and must not leave hangers
                self._fail_lost(lost)
                self._fail_queued("batcher is broken: %s" % self._broken)
                self._fail_pending("batcher is broken: %s" % self._broken)
                warnings.warn("serve batcher: %s — failing all pending "
                              "requests; the batcher refuses new submits"
                              % self._broken)
                return
            # counters BEFORE resolving the lost futures: callers woken
            # by the failure may immediately assert respawn progress
            self._respawns += 1
            self.stats.respawns += 1
            try:
                self._spawn_worker()
            except Exception:  # noqa: BLE001 — e.g. thread limit
                self._broken = "worker respawn failed"
                self._fail_lost(lost)
                self._fail_queued("batcher is broken: %s" % self._broken)
                self._fail_pending("batcher is broken: %s" % self._broken)
                raise
            self._fail_lost(lost)
        # --- reaper: anything unresolved past deadline+grace gets
        # DeadlineExceeded NOW — queued behind a backlog, lost in a
        # stale worker, or sitting on a wedged device alike
        now = time.monotonic()
        with self._plock:
            pending = list(self._pending)
        for r in pending:
            if r.t_deadline is not None and \
                    now >= r.t_deadline + self.grace:
                if _fail(r.future, DeadlineExceeded(
                        "request unresolved %.1f ms past its SLO "
                        "deadline (+%.0f ms grace) — reaped by the "
                        "watchdog; the engine may be wedged"
                        % ((now - r.t_deadline) * 1e3,
                           self.grace * 1e3))):
                    self.stats.inc("expired")

    def _fail_lost(self, lost):
        """Fail a dead worker's in-flight batch (in nobody's queue)."""
        for r in lost or ():
            if _fail(r.future, RuntimeError(
                    "batcher worker died mid-batch — request failed, "
                    "worker respawned")):
                self.stats.inc("failed")

    # ------------------------------------------------------------------
    def _fail_queued(self, msg: str = "batcher closed before this "
                                      "request was served"):
        """Fail every request still sitting in the queue (nobody will
        serve it).  Shared by ``close()``, the watchdog's broken path
        and the submit-side close-race seal; idempotent."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            _fail(r.future, RuntimeError(msg))

    def _fail_pending(self, msg: str):
        """Fail every admitted-but-unresolved request — including one
        lost inside a stale worker that will never report back.  The
        ``done()`` guard makes this race-safe against a worker that
        resolves concurrently; idempotent."""
        with self._plock:
            pending = list(self._pending)
        for r in pending:
            _fail(r.future, RuntimeError(msg))

    def close(self, join_timeout: float = 5.0):
        """Stop admission, serve what is queued, join worker + watchdog.

        The ``io/resilient.py`` drain-join discipline: stop is
        signalled first (pending submits wake), the worker drains the
        queue (every already-admitted request is served or failed),
        the bounded join WARNS when the worker is stale, and anything
        the stale worker left behind — queued or in flight — is failed
        on its future.  No request is ever silently dropped.  A submit
        that raced the stop flag and landed after this drain is failed
        by the submit-side seal (see :meth:`submit`)."""
        self._stop.set()
        self._thread.join(timeout=join_timeout)
        wd = getattr(self, "_watchdog", None)
        if wd is not None and wd is not threading.current_thread():
            wd.join(timeout=join_timeout)
        # the watchdog may have respawned a fresh worker while we were
        # joining the dead one — join the CURRENT reference too (it
        # drains and exits on the stop flag)
        t = self._thread
        if t.is_alive():
            t.join(timeout=join_timeout)
        if self._thread.is_alive():
            warnings.warn(
                "serve batcher worker did not exit within %gs — it is "
                "still blocked inside the engine; queued requests are "
                "being failed and the thread abandoned" % join_timeout)
        self._fail_queued()
        # a clean drain leaves nothing pending (every future resolved →
        # discarded); a stale worker's in-flight batch is still here
        self._fail_pending("batcher closed before this request was served")

    def __del__(self):
        try:
            if not self._stop.is_set():
                self.close(join_timeout=1.0)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
