"""Train->serve flywheel: the promotion daemon (port of
``incubator_mxnet_tpu/serve/flywheel.py``).

A supervised trainer commits elastic checkpoints
(``parallel/checkpoint.py``), and this daemon watches the checkpoint
directory -- COMMITTED steps only, via
:meth:`CheckpointManager.latest_committed`/``watch`` so staging debris
and torn manifests are invisible by construction — and walks each new
candidate through a promotion gauntlet before it may touch the live
:class:`~.engine.ServeEngine`:

1. **load** — the candidate's ``params`` leaves are read straight off
   the committed manifest (checksums verified; a corrupt payload
   quarantines the step, it never reaches the engine);
2. **held-out metric** — :meth:`ServeEngine.shadow_infer` scores the
   candidate against the serving incumbent on held-out rows (zero
   compiles, zero attribution motion); a candidate worse than the
   incumbent beyond ``metric_slack`` is quarantined *here*, before the
   swap path, so a diverged checkpoint never moves the engine's
   ``rollback_count``;
3. **swap gauntlet** — :meth:`ServeEngine.update_params` with
   ``context="promotion"`` runs the remaining gates in one shot: GL011
   swap-compatibility (eager, unsuppressible) and the canary replay
   with ``canary_tol`` drift rollback.  The daemon always passes a
   canary gate — an ungated ``update_params`` from a promotion context
   is what the reference's GL014 flags.

   Not ported: the reference's graftrange stage (the re-walk of the
   candidate's observed weight extrema under ``numerics="error"``) walks
   jaxprs; it waits for the port's analysis layer (ROADMAP A12), and
   the engine has no ``numerics=`` until then.

Every verdict is appended to a JSONL **promotion ledger**
(``promotions.jsonl`` beside the checkpoints) riding the supervisor's
:class:`~..parallel.supervisor.HealthLedger` discipline: append-only,
fsync'd, torn-tail tolerant, one writer.  ``tools/flywheel_torch.py``
reads it back; its chaos legs (``fault_injection.swap_storm``,
``loss_bomb``) assert over it.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.checkpoint import (CheckpointCorruptError, CheckpointError,
                                   CheckpointManager, _FORMAT_VERSION,
                                   _MANIFEST, _index_from_json)

__all__ = ["PromotionDaemon", "load_candidate_params", "read_promotions",
           "held_out_ce"]

#: manifest keys of the model-parameter leaves in a TrainStep checkpoint
#: (``_checkpoint_state()`` puts params first, in ``collect_params``
#: order — the same order ``ServeEngine`` pins its signature in)
_PARAM_KEY = re.compile(r"^\['params'\]\[(\d+)\]$")


def load_candidate_params(manager: CheckpointManager,
                          step: int) -> List[np.ndarray]:
    """Read ONE committed checkpoint's model parameters as ordered host
    arrays — the promotion candidate — without building a TrainStep.

    Reads the manifest directly (the daemon runs in the serving
    process; it has no training state tree to ``restore`` into) and
    selects the ``['params'][i]`` leaves, assembling sharded payloads
    and verifying checksums through the manager's own readers.  Raises
    :class:`CheckpointCorruptError` on any mismatch — the daemon turns
    that into a quarantine verdict, and the engine never sees the
    candidate.
    """
    d = manager._step_dir(int(step))
    try:
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError("missing manifest: %s" % e)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError("unreadable manifest: %s" % e)
    if manifest.get("format_version") != _FORMAT_VERSION:
        raise CheckpointCorruptError(
            "manifest format_version %r != %d"
            % (manifest.get("format_version"), _FORMAT_VERSION))
    picked: List[Tuple[int, Dict]] = []
    for entry in manifest.get("arrays", []):
        m = _PARAM_KEY.match(entry.get("key", ""))
        if m:
            picked.append((int(m.group(1)), entry))
    picked.sort(key=lambda t: t[0])
    if not picked:
        raise CheckpointCorruptError(
            "checkpoint step %d carries no ['params'][i] leaves — not a "
            "TrainStep checkpoint?" % step)
    if [i for i, _ in picked] != list(range(len(picked))):
        raise CheckpointCorruptError(
            "checkpoint step %d params indices are not contiguous: %s"
            % (step, [i for i, _ in picked]))
    arrays: List[np.ndarray] = []
    for _i, entry in picked:
        try:
            dtype = np.dtype(entry["dtype"])
            shape = tuple(entry["shape"])
            files = entry["files"]
            if len(files) == 1 and files[0].get("index") is None:
                arr = manager._read_part(d, files[0], dtype).reshape(shape)
            else:
                arr = np.empty(shape, dtype)
                for f in files:
                    part = manager._read_part(d, f, dtype) \
                        .reshape(tuple(f["part_shape"]))
                    arr[_index_from_json(f["index"], shape)] = part
            arrays.append(np.ascontiguousarray(arr))
        except CheckpointCorruptError:
            raise
        except (KeyError, IndexError, TypeError, ValueError) as e:
            raise CheckpointCorruptError(
                "undecodable manifest entry %r: %s" % (entry.get("key"), e))
    return arrays


def held_out_ce(outputs, labels) -> float:
    """Default held-out metric: mean softmax cross-entropy of the
    net's first output leaf against integer ``labels`` (lower is
    better), in f64 on the host.  Non-finite logits yield ``inf`` — an
    automatic quarantine, never a promotion."""
    from .engine import _leaves

    leaf = _leaves(outputs)[0]
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().double().numpy()
    out = np.asarray(leaf, np.float64)
    y = np.asarray(labels).astype(np.int64).reshape(-1)
    if out.ndim != 2 or out.shape[0] != y.shape[0]:
        raise ValueError("held-out logits %s do not match labels %s"
                         % (out.shape, y.shape))
    if not np.isfinite(out).all():
        return float("inf")
    out = out - out.max(axis=-1, keepdims=True)
    log_z = np.log(np.exp(out).sum(axis=-1))
    return float(np.mean(log_z - out[np.arange(out.shape[0]), y]))


def read_promotions(path: str) -> List[Dict]:
    """Parse a promotion ledger (JSONL; torn tail tolerated the way
    ``supervisor.read_ledger`` tolerates it — the daemon may be killed
    mid-append)."""
    events: List[Dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue  # torn tail
    except OSError:
        return []
    return events


class PromotionDaemon:
    """Watch a checkpoint directory and hot-swap gauntlet survivors
    into a live :class:`~.engine.ServeEngine`.

    ``held_out`` — ``(X, labels)`` rows the incumbent is known-good on;
    the candidate must score within ``metric_slack`` (relative) of the
    incumbent's ``metric_fn`` (default :func:`held_out_ce`, lower is
    better) or it is quarantined before the swap path.  ``None`` skips
    the metric stage (the canary gate still applies).

    ``canary``/``canary_tol`` — forwarded to
    :meth:`ServeEngine.update_params`; the default canary is the
    held-out rows with ``canary_tol=4.0``, so the daemon is never the
    ungated swap path the reference's GL014 warns about.  The loose
    default is deliberate: a continually-trained candidate legitimately drifts
    ~1x the incumbent's output scale early in training, so the canary
    here is the CATASTROPHE gate (non-finite output,
    order-of-magnitude drift — a diverged or mis-scaled candidate);
    fine-grained quality regression is the held-out metric stage's
    job, which runs first.

    The ledger (``promotions.jsonl`` under the manager's directory, or
    ``ledger_path``) records one event per verdict::

        {"event": "promoted",    "seq": n, "time": t, "step": s,
         "version": v, "from_version": u, "verdicts": {...},
         "metric": {"candidate": c, "incumbent": i}}
        {"event": "quarantined", "seq": n, "time": t, "step": s,
         "stage": "load"|"metric"|"swap", "reason": "...",
         "verdicts": {...}, "incumbent_version": u}

    ``verdicts`` maps every gauntlet stage the candidate reached to
    ``"ok"``/``"fail"``/``"skipped"`` (the reference's promotion
    matrix).  A quarantined step is remembered and never retried (the checkpoint content is immutable once committed); the
    daemon moves on to newer candidates only.
    """

    def __init__(self, manager: CheckpointManager, engine,
                 held_out: Optional[Tuple[Any, Any]] = None,
                 metric_fn: Optional[Callable[[Any, Any], float]] = None,
                 metric_slack: float = 0.02,
                 canary=None, canary_tol: Optional[float] = 4.0,
                 ledger_path: Optional[str] = None):
        from ..parallel.supervisor import HealthLedger

        self.manager = manager
        self.engine = engine
        self.held_out = held_out
        self.metric_fn = metric_fn or held_out_ce
        self.metric_slack = float(metric_slack)
        self._canary = canary
        self._canary_tol = canary_tol
        if canary is None and held_out is not None:
            self._canary = np.asarray(held_out[0])
        self.ledger_path = ledger_path or os.path.join(
            manager.directory, "promotions.jsonl")
        self.ledger = HealthLedger(self.ledger_path)
        self.promoted_count = 0
        self.quarantined_count = 0
        self.last_processed: Optional[int] = None
        self._seen: Dict[int, str] = {}   # step -> "promoted"/"quarantined"

    # ------------------------------------------------------------------
    def _quarantine(self, step: int, stage: str, reason: str,
                    verdicts: Dict[str, str]) -> Dict:
        self.quarantined_count += 1
        self._seen[step] = "quarantined"
        self.last_processed = step
        rec = {"step": int(step), "stage": stage,
               "reason": str(reason)[:500], "verdicts": dict(verdicts),
               "incumbent_version": self.engine.params_version}
        self.ledger.append("quarantined", **rec)
        rec["event"] = "quarantined"
        return rec

    def evaluate(self, step: int) -> Dict:
        """Run ONE committed candidate through the full gauntlet.
        Returns the ledger record (``event`` = ``promoted`` or
        ``quarantined``); never raises on a bad candidate — a gauntlet
        failure is a verdict, not an error."""
        from .engine import LintError
        from .resilience import SwapRejected

        verdicts: Dict[str, str] = {}
        # -- stage 1: load (checksummed read off the committed manifest)
        try:
            raw = load_candidate_params(self.manager, step)
        except (CheckpointCorruptError, CheckpointError) as e:
            verdicts["load"] = "fail"
            return self._quarantine(step, "load", str(e), verdicts)
        verdicts["load"] = "ok"
        # -- stage 2: held-out metric vs the serving incumbent (shadow
        # replay of warmed programs: zero compiles, no version motion,
        # and — crucially — BEFORE the swap path, so a diverged
        # candidate never moves engine.rollback_count)
        if self.held_out is not None:
            hx, hy = self.held_out
            try:
                cand_out = self.engine.shadow_infer(hx, candidate=raw)
            except (LintError, ValueError, RuntimeError) as e:
                verdicts["metric"] = "fail"
                return self._quarantine(step, "metric",
                                        "shadow run rejected: %s" % e,
                                        verdicts)
            inc_out = self.engine.shadow_infer(hx)
            cand_m = float(self.metric_fn(cand_out, hy))
            inc_m = float(self.metric_fn(inc_out, hy))
            bound = inc_m + abs(inc_m) * self.metric_slack + 1e-12
            if not np.isfinite(cand_m) or cand_m > bound:
                verdicts["metric"] = "fail"
                return self._quarantine(
                    step, "metric",
                    "held-out metric %.6g vs incumbent %.6g "
                    "(slack %.3g): candidate is worse"
                    % (cand_m, inc_m, self.metric_slack), verdicts)
            verdicts["metric"] = "ok"
            metric_rec = {"candidate": cand_m, "incumbent": inc_m}
        else:
            verdicts["metric"] = "skipped"
            metric_rec = None
        # -- stage 3: the swap gauntlet proper — GL011 signature gate,
        # canary replay with drift rollback
        from_version = self.engine.params_version
        try:
            version = self.engine.update_params(
                raw, canary=self._canary, canary_tol=self._canary_tol,
                context="promotion")
        except (SwapRejected, LintError) as e:
            verdicts["swap"] = "fail"
            return self._quarantine(step, "swap", str(e), verdicts)
        verdicts["swap"] = "ok"
        self.promoted_count += 1
        self._seen[step] = "promoted"
        self.last_processed = step
        rec = {"step": int(step), "version": int(version),
               "from_version": int(from_version),
               "verdicts": dict(verdicts)}
        if metric_rec is not None:
            rec["metric"] = metric_rec
        self.ledger.append("promoted", **rec)
        rec["event"] = "promoted"
        return rec

    # ------------------------------------------------------------------
    def poll_once(self, timeout: float = 0.0) -> Optional[Dict]:
        """Process the newest unseen committed candidate, waiting up to
        ``timeout`` seconds for one to appear.  Returns its ledger
        record, or ``None`` when nothing new committed in time.

        Only COMMITTED steps are ever considered
        (:meth:`CheckpointManager.latest_committed`): a mid-commit
        ``.tmp-`` stage or a torn ``step-*`` dir cannot reach the
        gauntlet by construction.  Steps older than the newest are
        skipped — promotion chases the freshest survivor, not the
        backlog."""
        deadline = time.monotonic() + float(timeout)
        while True:
            s = self.manager.latest_committed()
            if s is not None and s not in self._seen:
                return self.evaluate(s)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def run(self, until_step: Optional[int] = None,
            idle_timeout: float = 10.0) -> Dict[str, int]:
        """Poll until a candidate with step >= ``until_step`` has been
        processed (or, with ``None``, until ``idle_timeout`` passes
        with no new commit).  Returns summary counters — the CLI's
        (``tools/flywheel_torch.py``) foreground loop."""
        while True:
            rec = self.poll_once(timeout=idle_timeout)
            if rec is None:
                break
            if until_step is not None and rec["step"] >= until_step:
                break
        return {"promoted": self.promoted_count,
                "quarantined": self.quarantined_count}
