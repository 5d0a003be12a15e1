"""Serving-resilience policy: SLO deadlines, retry, circuit breaker (port
of ``incubator_mxnet_tpu/serve/resilience.py``, all of it).

The policy half of the serving layer that ``serve/batcher.py`` and
``serve/engine.py`` enforce:

- **per-request SLO deadlines** -- a request carries its own latency
  budget from ``submit(deadline=)``; work that has already expired is
  shed *before* compute, and a watchdog reaper makes the future resolve
  by deadline+epsilon even when the engine itself hangs.  Every future
  ends in exactly one of: a result, :class:`~.batcher.RequestError`
  (malformed), :class:`DeadlineExceeded`, :class:`Shed`, or the
  engine/worker error that killed its batch;
- **bounded retry** -- :class:`RetryPolicy` classifies engine failures
  as transient (retried with exponential backoff, never past the batch's
  tightest deadline) or terminal (fail fast);
- **circuit breaker** -- :class:`CircuitBreaker` trips after repeated
  engine failures, so a broken backend degrades at once instead of
  timing out every request: traffic goes to the batcher's fallback tier
  when it has one, else to priority-aware shedding (:class:`Shed`), and
  the breaker half-opens after a cooldown to probe recovery;
- **canaried hot weight swap** -- :class:`SwapRejected` is how
  ``ServeEngine.update_params()`` reports a rollback: the candidate
  failed its canary batch and the old version is still serving.

Everything here is plain Python: small objects owned by the batcher's
worker thread (the breaker) or raised across threads (the exceptions).
"""
from __future__ import annotations

import time
from typing import List, Tuple

__all__ = ["CircuitBreaker", "DeadlineExceeded", "RetryPolicy", "Shed",
           "SwapRejected", "classify_future"]


class DeadlineExceeded(TimeoutError):
    """This request's SLO deadline passed before it was served.  Raised
    on the request's future — by the worker (shed before compute: the
    request expired in the queue) or by the watchdog reaper (the
    enforcement backstop when the engine itself is stuck).  The batch
    it would have ridden in was served normally."""


class Shed(RuntimeError):
    """This request was deliberately dropped by overload policy — the
    circuit breaker is open and no fallback tier is available (or the
    request's priority lost the shedding decision).  Distinct from
    :class:`~.batcher.Backpressure` (queue-full at submit) and from an
    engine error: shedding is the service *choosing* not to serve,
    cheaply, instead of failing slowly."""


class SwapRejected(RuntimeError):
    """A hot weight swap was rolled back by its canary: the candidate
    version produced non-finite output or drifted beyond tolerance on
    the canary batch.  The previously-served version is still serving —
    a rejected swap is invisible to traffic.  ``reason`` carries the
    canary verdict."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__("weight swap rejected (old version still "
                         "serving): %s" % reason)


def classify_future(f, timeout: float = 0.0) -> str:
    """ONE copy of the terminal-outcome classification every collector
    (``poisson_loadtest``, ``serve_bench --chaos``) shares: wait up to
    ``timeout`` seconds, then name the outcome —

    - ``"ok"`` — resolved with a result;
    - ``"expired"`` — :class:`DeadlineExceeded` (SLO passed);
    - ``"shed"`` — :class:`Shed` (breaker overload policy);
    - ``"error"`` — any other *resolved* exception (engine/worker
      failure, ``RequestError``);
    - ``"hung"`` — STILL unresolved after the bound: the
      no-hang-invariant breach a chaos run exits 1 on.

    Handles the py3.11 aliasing (``concurrent.futures.TimeoutError``
    IS builtin ``TimeoutError`` there): a future that RESOLVED with a
    timeout-shaped engine error is an ``"error"``, never ``"hung"`` —
    only an undone future is a breach.
    """
    from concurrent.futures import TimeoutError as _FutureTimeout

    try:
        f.result(timeout=max(0.0, timeout))
        return "ok"
    except DeadlineExceeded:
        return "expired"
    except Shed:
        return "shed"
    except _FutureTimeout:
        return "error" if f.done() else "hung"
    except Exception:  # noqa: BLE001 — terminal outcomes are the point
        return "error"


class RetryPolicy:
    """Bounded transient-failure retry with exponential backoff.

    ``max_retries`` extra attempts per batch, ``backoff * multiplier**k``
    seconds before the k-th retry.  ``transient`` is the exception
    allowlist — by default ``RuntimeError``/``OSError``/``TimeoutError``
    (the shapes a flaky device runtime or a torn transfer presents);
    validation errors (``ValueError``: malformed batch, drifted shape)
    are deterministic and never retried.  The batcher additionally
    refuses any retry whose backoff would sleep past the batch's
    tightest SLO deadline — a retry that cannot finish in budget is a
    shed, not a retry.
    """

    def __init__(self, max_retries: int = 2, backoff: float = 0.005,
                 multiplier: float = 2.0,
                 transient: Tuple[type, ...] = (RuntimeError, OSError,
                                                TimeoutError)):
        if int(max_retries) < 0:
            raise ValueError("max_retries must be >= 0, got %r"
                             % (max_retries,))
        if float(backoff) < 0:
            raise ValueError("backoff must be >= 0 seconds, got %r"
                             % (backoff,))
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.multiplier = float(multiplier)
        self.transient = tuple(transient)

    def is_transient(self, exc: BaseException) -> bool:
        # policy exceptions are decisions, not faults — retrying a Shed
        # or a Backpressure would fight the overload control itself
        from .batcher import Backpressure

        if isinstance(exc, (Shed, DeadlineExceeded, Backpressure)):
            return False
        return isinstance(exc, self.transient)

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based)."""
        return self.backoff * (self.multiplier ** attempt)


class CircuitBreaker:
    """Three-state failure breaker for the serving path.

    ``closed`` (healthy) → ``open`` after ``failure_threshold``
    CONSECUTIVE batch failures (retries exhausted) → ``half_open`` after
    ``recovery_time`` seconds, when one live batch probes the primary
    engine: success closes the breaker, failure re-opens it and restarts
    the cooldown.  While open, :meth:`route` answers ``"degraded"`` and
    the batcher serves the fallback tier or sheds — the broken backend
    is not hammered, and requests fail in microseconds instead of
    timing out one by one.

    Owned by the batcher's single worker thread — no locking; reads
    from other threads (stats, tests) see a consistent snapshot via the
    GIL.  ``transitions`` records ``(monotonic_t, from, to)`` for the
    breaker-policy tests and the chaos report.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 recovery_time: float = 0.25):
        if int(failure_threshold) < 1:
            raise ValueError("failure_threshold must be >= 1, got %r"
                             % (failure_threshold,))
        if float(recovery_time) <= 0:
            raise ValueError("recovery_time must be positive seconds, "
                             "got %r" % (recovery_time,))
        self.failure_threshold = int(failure_threshold)
        self.recovery_time = float(recovery_time)
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.transitions: List[Tuple[float, str, str]] = []

    def _transition(self, to: str, now: float):
        self.transitions.append((now, self.state, to))
        self.state = to
        if to == self.OPEN:
            self.opened_at = now

    def route(self, now: float = None) -> str:
        """Where the next batch should go: ``"serve"`` (healthy
        primary), ``"probe"`` (half-open trial on the primary), or
        ``"degraded"`` (fallback tier / shedding)."""
        now = time.monotonic() if now is None else now
        if self.state == self.CLOSED:
            return "serve"
        if self.state == self.OPEN:
            if now - self.opened_at >= self.recovery_time:
                self._transition(self.HALF_OPEN, now)
                return "probe"
            return "degraded"
        # half_open: the worker is single-threaded, so the previous
        # probe batch already resolved (closing or re-opening the
        # breaker) before route() runs again; reaching here means the
        # probe outcome was never recorded — probe again rather than
        # wedge degraded forever
        return "probe"

    def record_success(self, now: float = None):
        now = time.monotonic() if now is None else now
        self.consecutive_failures = 0
        if self.state != self.CLOSED:
            self._transition(self.CLOSED, now)

    def record_failure(self, now: float = None):
        now = time.monotonic() if now is None else now
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN:
            # the probe failed: back to open, cooldown restarts
            self._transition(self.OPEN, now)
        elif self.state == self.CLOSED and \
                self.consecutive_failures >= self.failure_threshold:
            self._transition(self.OPEN, now)
        elif self.state == self.OPEN:
            # a high-priority best-effort attempt failed while open:
            # refresh the cooldown so probing backs off from a backend
            # that is still provably down
            self.opened_at = now
