"""Self-healing training: the run supervisor (port of
``incubator_mxnet_tpu/parallel/supervisor.py``).

The recovery primitives exist already: atomic checkpoints with a
fallback to the last intact one (``parallel/checkpoint.py``), mid-epoch
iterator resume (``io/resilient.py``), the elastic restore at another dp
width (``TrainStep.restore_checkpoint``), and in-step containment of
non-finite steps (``nonfinite="skip"``).  This module drives them:
**detection → policy ladder → automatic resume**, with a ledger of what
happened.

- **heartbeat protocol**: each rank writes a step-boundary heartbeat
  (step, loss, loss scale, skipped steps, wall time) as an atomic per-rank
  file in the checkpoint directory, through ``checkpoint._write_bytes``,
  the choke point of the checkpoint files (``fault_injection.fail_writes``
  reaches it, and a heartbeat outage warns instead of stopping training);
- **detectors**: pure verdict functions over the heartbeats: *hang* (no
  new heartbeat within ``stall_timeout``, calibrated from an EMA of the
  step time), *straggler* (a live rank whose applied steps fell a factor
  behind the median), *divergence* (:class:`DivergenceDetector`: a skip
  streak past its budget, or a finite loss EMA that explodes, which
  ``nonfinite="skip"`` cannot see);
- **policy ladder**, bounded at every rung, in this order:

  1. **in-process rollback** (:func:`run_supervised`, in each rank): a
     divergence verdict restores the last committed checkpoint
     (parameters, optimizer state, loss scale and the data stream's
     position) and goes on; after ``max_rollbacks`` the rank exits
     :data:`EXIT_DIVERGED` for the supervisor;
  2. **kill and respawn** (:class:`Supervisor`): a lost or wedged rank
     kills the whole job (the ranks' collectives are all or nothing) and
     launches it again after a jittered backoff; the ranks restore from
     the last committed checkpoint; ``max_restarts`` per width;
  3. **elastic shrink**: with the restart budget spent, the job is
     launched at dp ``width // shrink_factor`` (the elastic restore
     re-shards the ZeRO state and re-splits the iterator states), with a
     new budget;
  4. **give up**: a ``post_mortem`` ledger event with the evidence, and
     a return, never a hang (``run(timeout=)`` bounds the watch).

Every event (heartbeat gap, verdict, rollback, restart, shrink, recovery
with its MTTR, resolution, post-mortem) is appended to a JSONL health
ledger next to the checkpoints: ``health.jsonl`` for the supervisor,
``health-rNNNNN.jsonl`` for each rank, one writer a file, merged by
:func:`read_ledger`.  Heartbeat and ledger files are the JAX package's
format: either package reads the other's.

``tools/supervise_torch.py`` is the CLI: it launches the ranks through
``tools/launch_torch.py``'s ``DMLC_*`` protocol and drives the chaos
matrix (``--chaos kill_process|hang_step|straggler_process|
host_loss_during_save|loss_bomb|all``).
"""
from __future__ import annotations

import json
import math
import os
import random
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["DivergenceDetector", "DivergenceError", "EXIT_DIVERGED",
           "HealthLedger", "HeartbeatEmitter", "StepClock", "Supervisor",
           "SupervisorConfig", "SupervisorError", "committed_steps",
           "hang_verdicts", "read_heartbeats", "read_ledger",
           "run_supervised", "straggler_verdicts"]

#: Worker exit code for "divergence rollback budget exhausted" — the
#: in-process rung of the ladder handing off to the outer supervisor.
EXIT_DIVERGED = 13

_HEARTBEAT_FMT = "heartbeat-r%05d.json"
_LEDGER_SUPERVISOR = "health.jsonl"
_LEDGER_RANK_FMT = "health-r%05d.jsonl"


class SupervisorError(RuntimeError):
    """The supervised run cannot make progress (configuration error,
    or the bounded-call backstop tripped)."""


class DivergenceError(SupervisorError):
    """Divergence persisted through the in-process rollback budget —
    the caller (or the outer :class:`Supervisor`, via
    :data:`EXIT_DIVERGED`) must escalate to the next ladder rung."""


# ---------------------------------------------------------------------------
# heartbeat protocol
# ---------------------------------------------------------------------------

def _atomic_write_json(path: str, payload: Dict) -> None:
    """Write ``payload`` as JSON with the checkpoint layer's atomicity
    discipline: bytes through ``checkpoint._write_bytes`` (the fault-
    injection choke point) into a temp twin, then ``os.replace`` — a
    reader never sees a torn file, only the old or the new one."""
    from . import checkpoint as _ckpt

    data = json.dumps(payload, sort_keys=True).encode()
    tmp = path + ".tmp"
    _ckpt._write_bytes(tmp, data)
    os.replace(tmp, path)


class HeartbeatEmitter:
    """Per-rank step-boundary heartbeat writer.

    ``emit()`` publishes ``{rank, seq, step, loss, loss_scale,
    skipped_steps, status, time}`` atomically to
    ``heartbeat-rNNNNN.json`` in ``directory``.  A write failure warns
    and counts (``write_failures``) instead of raising: losing a
    heartbeat must degrade monitoring, never kill the training step
    that produced it."""

    def __init__(self, directory: str, rank: int = 0):
        self.directory = str(directory)
        self.rank = int(rank)
        self.seq = 0
        self.write_failures = 0
        self.path = os.path.join(self.directory,
                                 _HEARTBEAT_FMT % self.rank)

    def emit(self, step: int, loss: Optional[float] = None,
             loss_scale: Optional[float] = None, skipped_steps: int = 0,
             status: str = "running", **extra) -> Dict:
        self.seq += 1
        hb = {"rank": self.rank, "seq": self.seq, "step": int(step),
              "loss": None if loss is None else float(loss),
              "loss_scale": None if loss_scale is None
              else float(loss_scale),
              "skipped_steps": int(skipped_steps), "status": str(status),
              "time": time.time()}
        hb.update(extra)
        try:
            os.makedirs(self.directory, exist_ok=True)
            _atomic_write_json(self.path, hb)
        except OSError as e:
            self.write_failures += 1
            warnings.warn("heartbeat write failed (rank %d, seq %d): %s "
                          "— monitoring degraded, training continues"
                          % (self.rank, self.seq, e))
        return hb


def read_heartbeats(directory: str) -> Dict[int, Dict]:
    """All readable per-rank heartbeats under ``directory`` as
    ``{rank: payload}``.  Torn/unparseable files are skipped (the
    atomic-replace discipline makes them rare; a crash can still leave
    a ``.tmp`` twin, which is ignored by name)."""
    out: Dict[int, Dict] = {}
    if not os.path.isdir(str(directory)):
        return out
    for name in os.listdir(str(directory)):
        if not (name.startswith("heartbeat-r") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(str(directory), name)) as f:
                hb = json.load(f)
            out[int(hb["rank"])] = hb
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def committed_steps(directory: str) -> List[int]:
    """Committed checkpoint steps under ``directory``, ascending —
    the supervisor's (manager-free) view of what a restarted rank will
    restore from.  Only atomically-renamed ``step-NNNNNNNN`` dirs
    count; torn ``.tmp-step-*`` stages are invisible, exactly like
    ``CheckpointManager.steps()``."""
    if not os.path.isdir(str(directory)):
        return []
    out = []
    for name in os.listdir(str(directory)):
        if name.startswith("step-"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(out)


# ---------------------------------------------------------------------------
# health ledger
# ---------------------------------------------------------------------------

class HealthLedger:
    """Append-only JSONL event log, one writer per file.

    Each event is ``{"event": ..., "seq": n, "time": wall, **fields}``,
    appended as ONE fsync'd line (O(1) per event — the history is never
    rewritten).  Readers tolerate a torn trailing line (a crash
    mid-append), and re-opening a file whose last byte is not a newline
    first terminates the torn line so the next record cannot fuse onto
    it.  One ledger file has exactly ONE writer (the supervisor owns
    ``health.jsonl``, each rank its ``health-rNNNNN.jsonl``) and
    :func:`read_ledger` merges them by time."""

    def __init__(self, path: str):
        self.path = str(path)
        self._events: List[Dict] = list(_read_jsonl(self.path))
        self._seq = max((e.get("seq", 0) for e in self._events),
                        default=0)
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                self._needs_newline = f.read(1) != b"\n"
        except OSError:
            self._needs_newline = False  # absent or empty file

    def append(self, event: str, **fields) -> Dict:
        self._seq += 1
        rec = {"event": str(event), "seq": self._seq,
               "time": time.time()}
        rec.update(fields)
        self._events.append(rec)
        line = json.dumps(rec, sort_keys=True, default=str) + "\n"
        if self._needs_newline:
            line = "\n" + line  # seal a previous torn append
        try:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.path, "ab") as f:
                f.write(line.encode())
                f.flush()
                os.fsync(f.fileno())
            self._needs_newline = False
        except OSError as e:
            warnings.warn("health-ledger write failed (%s): %s — event "
                          "kept in memory only" % (self.path, e))
        return rec

    def events(self, event: Optional[str] = None) -> List[Dict]:
        if event is None:
            return list(self._events)
        return [e for e in self._events if e.get("event") == event]


def _read_jsonl(path: str):
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except ValueError:
            continue  # torn trailing line from a pre-atomic writer


def read_ledger(directory: str) -> List[Dict]:
    """Every health event under ``directory`` (the supervisor's file
    plus every rank's), merged in time order — the forensic record a
    post-mortem walks (docs/RESILIENCE.md §7)."""
    events: List[Dict] = []
    if not os.path.isdir(str(directory)):
        return events
    for name in sorted(os.listdir(str(directory))):
        if name == _LEDGER_SUPERVISOR or (name.startswith("health-r")
                                          and name.endswith(".jsonl")):
            events.extend(_read_jsonl(os.path.join(str(directory), name)))
    events.sort(key=lambda e: (e.get("time", 0.0), e.get("seq", 0)))
    return events


# ---------------------------------------------------------------------------
# detectors (pure verdict functions)
# ---------------------------------------------------------------------------

class StepClock:
    """EMA of step (heartbeat-arrival) intervals, the auto-calibration
    behind the hang detector: ``stall_timeout()`` answers
    ``max(floor, factor × EMA)`` once two arrivals have been seen, else
    ``startup_timeout`` (the first step pays compile time — a fixed
    small timeout would kill every cold start)."""

    def __init__(self, alpha: float = 0.3, factor: float = 8.0,
                 floor: float = 2.0, startup_timeout: float = 120.0):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1], got %r" % (alpha,))
        self.alpha = float(alpha)
        self.factor = float(factor)
        self.floor = float(floor)
        self.startup_timeout = float(startup_timeout)
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def observe(self, now: float) -> None:
        """Feed one arrival (any rank's NEW heartbeat)."""
        if self._last is not None:
            dt = max(0.0, now - self._last)
            self.ema = dt if self.ema is None else \
                self.alpha * dt + (1 - self.alpha) * self.ema
        self._last = now

    def stall_timeout(self) -> float:
        if self.ema is None:
            return self.startup_timeout
        return max(self.floor, self.factor * self.ema)


def hang_verdicts(heartbeats: Dict[int, Dict], now: float,
                  timeout: float,
                  last_seen: Optional[Dict[int, float]] = None
                  ) -> List[Dict]:
    """Ranks whose freshest heartbeat is older than ``timeout``.

    ``last_seen`` (rank → local arrival time on the CALLER's clock,
    maintained by the watcher) takes precedence over the heartbeat's
    own ``time`` stamp so a cross-host clock skew can't fabricate a
    hang; ranks with no heartbeat at all are the CALLER's to age (it
    knows launch time).  When ``last_seen`` is given, ``now`` must be
    on ITS clock and a rank absent from it starts aging at ``now``
    (the payload stamp is wall time — aging it against a monotonic
    ``now`` would yield a huge negative age that can never flag); the
    payload stamp is consulted only when no ``last_seen`` is supplied
    at all, i.e. a pure wall-clock caller.
    Returns ``[{rank, age, timeout}]``."""
    out = []
    for rank, hb in sorted(heartbeats.items()):
        if hb.get("status") in ("done", "diverged", "failed"):
            continue  # a finished rank stops beating by design
        if last_seen is None:
            seen = hb.get("time", now)
        else:
            seen = last_seen.get(rank, now)
        age = now - seen
        if age > timeout:
            out.append({"rank": rank, "age": age, "timeout": timeout})
    return out


def straggler_verdicts(heartbeats: Dict[int, Dict],
                       factor: float = 3.0,
                       min_lag: int = 4) -> List[Dict]:
    """Live ranks whose applied-step count fell behind the (upper)
    median by more than a factor of ``factor`` AND at least ``min_lag``
    steps — the still-beating-but-slow host the hang detector cannot
    see.  Startup jitter never flags: below ``min_lag`` steps of lag
    there is no verdict.  Ranks that already finished (``"done"``)
    keep anchoring the median — a crawling rank whose healthy peers
    all completed is still a straggler — but only ``"running"`` ranks
    can be flagged."""
    live = {r: hb for r, hb in heartbeats.items()
            if hb.get("status") == "running"}
    ref = [hb for hb in heartbeats.values()
           if hb.get("status") in ("running", "done")]
    if not live or len(ref) < 2:
        return []
    steps = sorted(int(hb.get("step", 0)) for hb in ref)
    median = steps[len(steps) // 2]
    out = []
    for rank, hb in sorted(live.items()):
        step = int(hb.get("step", 0))
        lag = median - step
        if lag >= max(int(min_lag), 1) and step * float(factor) < median:
            out.append({"rank": rank, "step": step, "median": median,
                        "lag": lag})
    return out


class DivergenceDetector:
    """Per-rank divergence verdicts over the (loss, applied-step,
    skipped-step) stream — the failure class ``nonfinite="skip"``
    cannot catch, in two shapes:

    - ``"skip_streak"`` — ``skip_streak_budget``-many CONSECUTIVE
      skipped steps (cumulative ``skipped_steps`` rising while the
      applied step count stands still): under a static loss scale the
      scale never adapts, so an unbounded streak is a stalled run that
      looks alive (the JAX package's lint flags the configuration as
      GL012; this detector catches it live);
    - ``"loss_explosion"`` — the EMA of *finite* losses grew by
      ``explosion_factor`` over its own post-warmup minimum, sustained
      for ``patience`` consecutive updates (one hot batch is noise; an
      exploding trend is divergence).  A non-finite loss observation
      is never fed to the EMA (the skip guard already owns that step).
      The minimum is LEAKY (``baseline_leak`` per update): it slowly
      forgets ancient lows, so a run long-converged at a tiny loss is
      not flagged for a benign drift measured against a stale
      months-old minimum — a real explosion outruns the leak by orders
      of magnitude.
    """

    def __init__(self, skip_streak_budget: Optional[int] = None,
                 explosion_factor: float = 1e3, ema_alpha: float = 0.2,
                 patience: int = 2, warmup: int = 3,
                 baseline_leak: float = 0.01):
        if skip_streak_budget is not None and int(skip_streak_budget) < 1:
            raise ValueError("skip_streak_budget must be >= 1 or None, "
                             "got %r" % (skip_streak_budget,))
        if float(explosion_factor) <= 1:
            raise ValueError("explosion_factor must be > 1, got %r"
                             % (explosion_factor,))
        if int(patience) < 1:
            raise ValueError("patience must be >= 1, got %r" % (patience,))
        self.skip_streak_budget = None if skip_streak_budget is None \
            else int(skip_streak_budget)
        self.explosion_factor = float(explosion_factor)
        self.ema_alpha = float(ema_alpha)
        self.patience = int(patience)
        self.warmup = int(warmup)
        if float(baseline_leak) < 0:
            raise ValueError("baseline_leak must be >= 0, got %r"
                             % (baseline_leak,))
        self.baseline_leak = float(baseline_leak)
        self.reset()

    def reset(self) -> None:
        """Forget history — call after a rollback restored known-good
        state (the pre-rollback EMA would instantly re-flag it)."""
        self.skip_streak = 0
        self.ema: Optional[float] = None
        self.ema_min: Optional[float] = None
        self._finite_seen = 0
        self._hot = 0
        self._last_step: Optional[int] = None
        self._last_skipped = 0

    def update(self, step: int, loss: Optional[float],
               skipped_steps: int = 0) -> Optional[str]:
        step, skipped_steps = int(step), int(skipped_steps)
        # -- skip streak: skips rising while the applied step stalls
        if self._last_step is not None:
            if skipped_steps > self._last_skipped and \
                    step <= self._last_step:
                self.skip_streak += skipped_steps - self._last_skipped
            elif step > self._last_step:
                self.skip_streak = 0
        self._last_step, self._last_skipped = step, skipped_steps
        if self.skip_streak_budget is not None and \
                self.skip_streak >= self.skip_streak_budget:
            return "skip_streak"
        # -- loss-explosion EMA (finite observations only)
        if loss is None or not math.isfinite(loss):
            return None
        self._finite_seen += 1
        a = self.ema_alpha
        self.ema = loss if self.ema is None else a * loss + (1 - a) * self.ema
        if self._finite_seen < self.warmup:
            return None
        if self.ema_min is None:
            self.ema_min = abs(self.ema)
        else:
            # leaky minimum: the baseline rises toward the current
            # level a little every update, bounding the lookback
            self.ema_min = min(self.ema_min * (1 + self.baseline_leak),
                               abs(self.ema))
        baseline = max(self.ema_min, 1e-12)
        if abs(self.ema) > self.explosion_factor * baseline:
            self._hot += 1
            if self._hot >= self.patience:
                return "loss_explosion"
        else:
            self._hot = 0
        return None

    @property
    def suspicious(self) -> bool:
        """True while the stream looks unhealthy but is still below
        verdict threshold — an active skip streak, a hot explosion
        count, or a loss EMA more than 10× its post-warmup minimum.
        The supervised loop DEFERS boundary checkpoints while this
        holds: a checkpoint of a quietly-diverging run would poison
        the very rollback target the verdict needs (conservative by
        design — a genuine sustained 10× loss rise defers saves until
        it either trips the verdict or decays back)."""
        if self.skip_streak > 0 or self._hot > 0:
            return True
        if self.ema is not None and self.ema_min is not None:
            return abs(self.ema) > 10.0 * max(self.ema_min, 1e-12)
        return False


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

class SupervisorConfig:
    """Knobs for both halves of the loop (worker rung + watchdog).
    All durations are seconds; see docs/RESILIENCE.md §7 for the
    threshold table."""

    def __init__(self,
                 # detection
                 stall_timeout: Optional[float] = None,
                 stall_factor: float = 8.0,
                 min_stall_timeout: float = 2.0,
                 startup_timeout: float = 120.0,
                 straggler_factor: float = 3.0,
                 straggler_min_lag: int = 4,
                 straggler_grace: float = 2.0,
                 skip_streak_budget: int = 16,
                 explosion_factor: float = 1e3,
                 ema_alpha: float = 0.2,
                 divergence_patience: int = 2,
                 # ladder budgets
                 max_rollbacks: int = 1,
                 max_restarts: int = 2,
                 backoff: float = 0.25,
                 min_width: int = 1,
                 shrink_factor: int = 2,
                 # mechanics
                 poll_interval: float = 0.05,
                 checkpoint_every: Optional[int] = 2):
        if stall_timeout is not None and float(stall_timeout) <= 0:
            raise ValueError("stall_timeout must be positive seconds or "
                             "None (auto), got %r" % (stall_timeout,))
        if int(max_restarts) < 0 or int(max_rollbacks) < 0:
            raise ValueError("budgets must be >= 0")
        if int(shrink_factor) < 2:
            raise ValueError("shrink_factor must be >= 2, got %r"
                             % (shrink_factor,))
        if int(min_width) < 1:
            raise ValueError("min_width must be >= 1, got %r"
                             % (min_width,))
        self.stall_timeout = stall_timeout
        self.stall_factor = float(stall_factor)
        self.min_stall_timeout = float(min_stall_timeout)
        self.startup_timeout = float(startup_timeout)
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_lag = int(straggler_min_lag)
        self.straggler_grace = float(straggler_grace)
        self.skip_streak_budget = int(skip_streak_budget)
        self.explosion_factor = float(explosion_factor)
        self.ema_alpha = float(ema_alpha)
        self.divergence_patience = int(divergence_patience)
        self.max_rollbacks = int(max_rollbacks)
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.min_width = int(min_width)
        self.shrink_factor = int(shrink_factor)
        self.poll_interval = float(poll_interval)
        self.checkpoint_every = None if checkpoint_every is None \
            else int(checkpoint_every)

    def make_detector(self,
                      skip_budget: Optional[int] = None
                      ) -> DivergenceDetector:
        return DivergenceDetector(
            skip_streak_budget=self.skip_streak_budget
            if skip_budget is None else skip_budget,
            explosion_factor=self.explosion_factor,
            ema_alpha=self.ema_alpha,
            patience=self.divergence_patience)


# ---------------------------------------------------------------------------
# the supervised train loop (runs INSIDE each rank)
# ---------------------------------------------------------------------------

def _run_step(step, x, y):
    """The one choke point every supervised step call goes through —
    module-level so the fault harness can interpose a wedge
    (``fault_injection.hang_step``) or a finite gradient bomb
    (``fault_injection.loss_bomb``) without touching the loop."""
    return step(x, y)


def _save_checkpoint(step, manager, data_iter):
    """Boundary-save choke point (``fault_injection`` scenarios that
    must die or stall exactly mid-save arm themselves here)."""
    return step.save_checkpoint(manager, data_iter=data_iter)


def _scale_params(step, factor: float) -> int:
    """Multiply every floating trained parameter of ``step`` in place by
    ``factor``: the ``loss_bomb`` payload.  The gradients stay finite,
    the loss explodes, ``nonfinite="skip"`` never fires, and only a
    rollback to a checkpoint heals the run.  The step's f32 master
    tensors are scaled in place under ``torch.no_grad()`` (leaves stay
    leaves): the parameters, and under ``multi_precision`` the master
    copies in the optimizer state that the update reads.  Returns how
    many parameters were scaled."""
    import torch

    n = 0
    with torch.no_grad():
        for i, p in enumerate(step._gp):
            if not p.is_floating_point():
                continue
            p.mul_(torch.tensor(factor, dtype=p.dtype, device=p.device))
            if step.opt.multi_precision:
                _, w32 = step.opt._unpack(step._opt_state[i])
                w32.mul_(torch.tensor(factor, dtype=w32.dtype,
                                      device=w32.device))
            n += 1
    return n


def _next_batch(data_iter):
    """One (x, y) from a DataIter-protocol iterator, resetting across
    epoch ends."""
    try:
        batch = data_iter.next()
    except StopIteration:
        data_iter.reset()
        batch = data_iter.next()
    return batch.data[0], batch.label[0]


def run_supervised(step, data_iter, manager, until_step: int,
                   config: Optional[SupervisorConfig] = None,
                   rank: int = 0, heartbeat_dir: Optional[str] = None,
                   ledger: Optional[HealthLedger] = None,
                   on_step: Optional[Callable[[Dict], None]] = None
                   ) -> Dict:
    """Drive ``step`` to ``until_step`` applied updates under
    supervision — the per-rank half of the ladder.

    Every step boundary: emit a heartbeat, feed the divergence
    detector, honor the periodic checkpoint schedule
    (``config.checkpoint_every`` applied steps, iterator state
    included).  On a divergence verdict: roll back to the last
    committed checkpoint (data stream included — the replayed batches
    are the SAME batches), bounded by ``config.max_rollbacks``; an
    exhausted budget (or no committed checkpoint to roll back to)
    raises :class:`DivergenceError` — the outer supervisor's cue to
    respawn/shrink.  If the manager already holds a committed step, the
    loop RESUMES from it first (the respawn rung lands here).

    The loop reads the loss, the step counters and the loss scale once
    a step, in one copy from the device (``step.boundary_scalars``).

    Returns ``{"losses": [...], "final_step": n, "rollbacks": k,
    "restored_from": step-or-None}``.  Bounded: a loop that cannot
    reach ``until_step`` within ``8×until_step + 64`` calls raises
    :class:`SupervisorError` instead of spinning forever.
    """
    cfg = config or SupervisorConfig()
    hb_dir = str(heartbeat_dir or manager.directory)
    emitter = HeartbeatEmitter(hb_dir, rank)
    if ledger is None:
        ledger = HealthLedger(os.path.join(hb_dir,
                                           _LEDGER_RANK_FMT % rank))
    budget = getattr(step, "skip_streak_budget", None)
    detector = cfg.make_detector(skip_budget=budget)
    restored_from = None
    if manager.latest_step() is not None:
        restored_from = step.restore_checkpoint(manager,
                                                data_iter=data_iter)
        ledger.append("resume", rank=rank, from_step=int(restored_from))
    rollbacks = 0
    fault_t: Optional[float] = None
    fault_target: Optional[int] = None  # rollback step; recovered past it
    losses: List[float] = []
    calls = 0
    max_calls = 8 * int(until_step) + 64
    applied = int(step.step_count)
    while applied < int(until_step):
        if calls >= max_calls:
            emitter.emit(applied, status="failed")
            raise SupervisorError(
                "supervised loop made no progress: %d calls produced "
                "only %d/%d applied steps" % (calls, applied, until_step))
        calls += 1
        x, y = _next_batch(data_iter)
        out = _run_step(step, x, y)
        loss, applied, skipped, scale = step.boundary_scalars(out)
        losses.append(loss)
        hb = emitter.emit(applied, loss=loss, loss_scale=scale,
                          skipped_steps=skipped)
        if on_step is not None:
            on_step(hb)
        if getattr(step, "sync", "allreduce") == "auto":
            # sync→async policy ladder (docs/RESILIENCE.md §8): the
            # straggler detector's verdicts feed the step's hysteresis
            # policy every boundary; a rung switch is a ledger event.
            # EVERY rank sees the same shared heartbeat set, so every
            # rank flips on (approximately) the same frame — including
            # the straggler itself, which must stop blocking its peers
            stragglers = straggler_verdicts(
                read_heartbeats(hb_dir), factor=cfg.straggler_factor,
                min_lag=cfg.straggler_min_lag)
            before = step.sync_mode
            after = step.observe_stragglers(
                [v["rank"] for v in stragglers])
            if after != before:
                ledger.append(
                    "sync_degrade" if after == "async" else "sync_recover",
                    rank=rank, mode=after, step=applied,
                    stragglers=[v["rank"] for v in stragglers])
        if fault_t is not None and fault_target is not None and \
                applied > fault_target:
            # first APPLIED step past the rollback point = recovered —
            # a post-rollback step that was itself skipped is not
            # progress, and must not mint a recovery/MTTR record
            ledger.append("recovered", rank=rank, mode="rollback",
                          step=applied, mttr=time.time() - fault_t)
            fault_t = fault_target = None
        verdict = detector.update(applied, loss, skipped)
        if verdict is not None:
            fault_t = time.time()
            ledger.append("divergence", rank=rank, verdict=verdict,
                          step=applied, loss=loss,
                          skip_streak=detector.skip_streak)
            last = manager.latest_step()
            if rollbacks >= cfg.max_rollbacks or last is None:
                emitter.emit(applied, loss=loss, status="diverged",
                             skipped_steps=skipped)
                ledger.append("rollback_exhausted", rank=rank,
                              rollbacks=rollbacks,
                              budget=cfg.max_rollbacks,
                              has_checkpoint=last is not None)
                raise DivergenceError(
                    "divergence (%s) at step %d persisted through %d "
                    "rollback(s)%s — escalate (respawn/shrink) or "
                    "inspect the health ledger" %
                    (verdict, applied, rollbacks,
                     "" if last is not None
                     else "; no committed checkpoint to roll back to"))
            to = step.restore_checkpoint(manager, data_iter=data_iter)
            fault_target = int(to)
            rollbacks += 1
            detector.reset()
            ledger.append("rollback", rank=rank, to_step=int(to),
                          verdict=verdict)
            applied = int(step.step_count)
            emitter.emit(applied, status="running",
                         skipped_steps=step.skipped_steps)
            continue
        if cfg.checkpoint_every is not None and applied > 0 and \
                applied % cfg.checkpoint_every == 0 and \
                applied > (manager.latest_step() or -1) and \
                not detector.suspicious:
            try:
                _save_checkpoint(step, manager, data_iter)
            except BaseException as e:
                # a failed periodic save must not kill a healthy rank:
                # the last committed checkpoint still stands, and the
                # outer supervisor owns any escalation (a dead PEER
                # surfaces through ITS exit, not ours)
                ledger.append("save_failed", rank=rank, step=applied,
                              error="%s: %s" % (type(e).__name__, e))
                warnings.warn("supervised checkpoint save at step %d "
                              "failed (%s: %s); continuing on the last "
                              "committed checkpoint" %
                              (applied, type(e).__name__, e))
    emitter.emit(applied, loss=losses[-1] if losses else None,
                 loss_scale=step.loss_scale,
                 skipped_steps=step.skipped_steps, status="done")
    ledger.append("done", rank=rank, step=applied, rollbacks=rollbacks)
    return {"losses": losses, "final_step": applied,
            "rollbacks": rollbacks, "restored_from": restored_from}


# ---------------------------------------------------------------------------
# the watchdog + policy ladder (runs in the SUPERVISOR process)
# ---------------------------------------------------------------------------

class Supervisor:
    """Process-0 watchdog owning a fleet of training ranks.

    ``launch(width, attempt)`` (caller-supplied) starts one job at the
    given dp width and returns a list of process handles exposing the
    ``subprocess.Popen`` liveness surface (``poll() -> rc|None``,
    ``terminate()``, ``kill()``, ``wait(timeout=)``) — the CLI spawns
    interpreters through ``tools/launch_torch.py``'s ``spawn_workers``
    (each rank in a session of its own, killed with its process group),
    the ladder tests drive scripted stubs.

    :meth:`run` watches heartbeats + process exits, forms verdicts
    (hang / straggler / lost rank / in-worker divergence escalation),
    and walks the bounded ladder: kill-and-respawn with jittered
    backoff (``max_restarts`` per width) → elastic shrink
    (``width // shrink_factor``, fresh budget) → give-up post-mortem.
    Ranks re-enter through :func:`run_supervised`, which restores the
    last committed checkpoint — so every recovery resumes from
    committed state, and a torn stage is never visible by construction.
    """

    def __init__(self, launch: Callable[[int, int], Sequence[Any]],
                 width: int, directory: str,
                 config: Optional[SupervisorConfig] = None):
        if int(width) < 1:
            raise ValueError("width must be >= 1, got %r" % (width,))
        self.launch = launch
        self.width = int(width)
        self.directory = str(directory)
        self.config = config or SupervisorConfig()
        os.makedirs(self.directory, exist_ok=True)
        self.ledger = HealthLedger(os.path.join(self.directory,
                                                _LEDGER_SUPERVISOR))
        self.restarts = 0        # total, all widths
        self.shrinks = 0
        self.mttrs: List[float] = []
        self._procs: List[Any] = []

    # -- mechanics -------------------------------------------------------
    def _kill_job(self):
        live = [p for p in self._procs if p.poll() is None]
        for p in live:
            try:
                p.terminate()
            except OSError:
                pass
        for p in live:
            try:
                p.wait(timeout=5)
            except Exception:
                try:
                    p.kill()
                    p.wait(timeout=5)
                except Exception:
                    pass
        self._procs = []

    def _clear_heartbeats(self):
        """Drop stale heartbeat files before a relaunch: a dead rank's
        old file (or a rank beyond a shrunken width) must not age into
        a fake hang verdict against the fresh job."""
        for name in os.listdir(self.directory):
            if name.startswith("heartbeat-r"):
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass

    def _resume_target(self) -> int:
        steps = committed_steps(self.directory)
        return (steps[-1] + 1) if steps else 1

    # -- the watch loop --------------------------------------------------
    def run(self, timeout: float = 600.0) -> Dict:
        """Supervise until the job resolves or the ladder gives up.
        Returns the outcome record (also appended to the ledger):
        ``{"outcome": "resolved"|"gave_up", "width": final_width,
        "restarts": n, "shrinks": k, "mttrs": [...], ...}``.  Bounded
        by ``timeout`` — on expiry the job is killed and a post-mortem
        written: the supervisor itself never hangs."""
        cfg = self.config
        width = self.width
        attempt = 0
        restarts_this_width = 0
        deadline = time.monotonic() + float(timeout)
        # ONE clock per rank: the EMA must measure a rank's own
        # heartbeat interval — feeding all ranks into one clock would
        # calibrate the timeout to step_time / width and flag healthy
        # wide fleets as hung.  The WIDEST rank's timeout governs.
        clocks: Dict[int, StepClock] = {}

        def stall_bound() -> float:
            if cfg.stall_timeout:
                return cfg.stall_timeout
            bounds = [c.stall_timeout() for c in clocks.values()
                      if c.ema is not None]
            return max(bounds) if bounds else cfg.startup_timeout

        last_seen: Dict[int, float] = {}
        last_seq: Dict[int, int] = {}
        straggler_since: Dict[int, float] = {}
        pending_fault: Optional[Dict] = None
        self._clear_heartbeats()
        self._procs = list(self.launch(width, attempt))
        launch_t = time.monotonic()
        self.ledger.append("launch", width=width, attempt=attempt)

        def verdictify(verdict: str, **detail) -> None:
            nonlocal pending_fault
            self.ledger.append("fault", verdict=verdict, width=width,
                               attempt=attempt, **detail)
            if pending_fault is None:
                pending_fault = {"verdict": verdict,
                                 "t": time.monotonic(),
                                 "resume_target": self._resume_target()}

        while True:
            if time.monotonic() > deadline:
                self._kill_job()
                return self._post_mortem("supervisor timeout", width)
            time.sleep(cfg.poll_interval)
            now_mono = time.monotonic()
            hbs = read_heartbeats(self.directory)
            for rank, hb in hbs.items():
                if hb.get("seq", 0) > last_seq.get(rank, 0):
                    last_seq[rank] = hb["seq"]
                    last_seen[rank] = now_mono
                    clocks.setdefault(rank, StepClock(
                        factor=cfg.stall_factor,
                        floor=cfg.min_stall_timeout,
                        startup_timeout=cfg.startup_timeout,
                    )).observe(now_mono)
            # recovery confirmation: a fresh heartbeat past the resume
            # target closes the pending fault and records its MTTR
            if pending_fault is not None:
                tgt = pending_fault["resume_target"]
                if any(hb.get("step", -1) >= tgt for hb in hbs.values()):
                    mttr = time.monotonic() - pending_fault["t"]
                    self.mttrs.append(mttr)
                    self.ledger.append("recovered", mode="respawn",
                                       verdict=pending_fault["verdict"],
                                       mttr=mttr, width=width)
                    pending_fault = None
            rcs = [p.poll() for p in self._procs]
            if rcs and all(rc == 0 for rc in rcs):
                out = {"outcome": "resolved", "width": width,
                       "restarts": self.restarts, "shrinks": self.shrinks,
                       "mttrs": list(self.mttrs),
                       "final_step": max(
                           [hb.get("step", 0) for hb in hbs.values()],
                           default=0)}
                self.ledger.append("resolved", **out)
                return out
            # -- lost / diverged ranks ----------------------------------
            dead = [(r, rc) for r, rc in enumerate(rcs)
                    if rc not in (None, 0)]
            if dead:
                rank, rc = dead[0]
                verdict = "divergence_exhausted" \
                    if rc == EXIT_DIVERGED else "lost_rank"
                verdictify(verdict, rank=rank, returncode=rc)
            else:
                # -- hang: no fresh heartbeat within the stall timeout
                stall = stall_bound()
                hung = hang_verdicts(hbs, now_mono, stall,
                                     last_seen=last_seen)
                # ranks that never beat at all age from launch time
                beatless = [r for r in range(width) if r not in hbs]
                if beatless and now_mono - launch_t > max(
                        stall, cfg.startup_timeout):
                    hung.extend({"rank": r,
                                 "age": now_mono - launch_t,
                                 "timeout": cfg.startup_timeout}
                                for r in beatless)
                if hung:
                    for h in hung:
                        self.ledger.append("heartbeat_gap", **h)
                    verdictify("hang", ranks=[h["rank"] for h in hung],
                               stall_timeout=stall)
                else:
                    # -- straggler: beating, but a factor behind
                    strag = straggler_verdicts(
                        hbs, factor=cfg.straggler_factor,
                        min_lag=cfg.straggler_min_lag)
                    for s in strag:
                        r = s["rank"]
                        if r not in straggler_since:
                            straggler_since[r] = now_mono
                            self.ledger.append("straggler", **s)
                    for r in list(straggler_since):
                        if r not in {s["rank"] for s in strag}:
                            del straggler_since[r]
                    over = [r for r, t0 in straggler_since.items()
                            if now_mono - t0 > cfg.straggler_grace]
                    if over:
                        verdictify("straggler", ranks=sorted(over))
                    else:
                        continue  # healthy poll
            # -- the ladder: respawn → shrink → give up -----------------
            self._kill_job()
            restarts_this_width += 1
            if restarts_this_width > cfg.max_restarts:
                if width > cfg.min_width:
                    new_width = max(cfg.min_width,
                                    width // cfg.shrink_factor)
                    self.ledger.append("shrink", from_width=width,
                                       to_width=new_width,
                                       restarts_at_width=restarts_this_width
                                       - 1)
                    self.shrinks += 1
                    width = new_width
                    restarts_this_width = 1  # this relaunch counts
                else:
                    return self._post_mortem(
                        "restart budget exhausted at min width", width)
            attempt += 1
            self.restarts += 1
            time.sleep(cfg.backoff * attempt *
                       (0.5 + random.random()))  # jittered
            self._clear_heartbeats()
            last_seen.clear()
            last_seq.clear()
            straggler_since.clear()
            # fresh calibration for the fresh job: folding the outage
            # interval (kill → backoff → respawn → first compile) into
            # the EMA would inflate the stall timeout for the whole
            # relaunch, and after a shrink the clocks of ranks beyond
            # the new width must stop contributing to the bound
            clocks.clear()
            self._procs = list(self.launch(width, attempt))
            launch_t = time.monotonic()
            self.ledger.append("restart", width=width, attempt=attempt,
                               restarts_at_width=restarts_this_width)

    def _post_mortem(self, reason: str, width: int) -> Dict:
        """Give up loudly: one ledger event carrying the evidence a
        human (or the next tool) needs — no hang, no silent exit."""
        events = self.ledger.events()
        counts: Dict[str, int] = {}
        for e in events:
            counts[e["event"]] = counts.get(e["event"], 0) + 1
        out = {"outcome": "gave_up", "reason": reason, "width": width,
               "restarts": self.restarts, "shrinks": self.shrinks,
               "mttrs": list(self.mttrs),
               "committed_steps": committed_steps(self.directory),
               "last_heartbeats": read_heartbeats(self.directory),
               "event_counts": counts}
        self.ledger.append("post_mortem", **out)
        return out
