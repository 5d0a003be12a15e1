"""Resilient input pipeline: fault-tolerant prefetch over any iterator
(port of ``incubator_mxnet_tpu/io/resilient.py``).

- **bounded background prefetch** — one ordered puller thread feeding a
  depth-``prefetch`` queue, joined by ``close()``, ``__del__`` and the
  epoch's end.  Pulls are sequential: a stateful iterator advanced
  concurrently would deliver batches out of order and make a mid-epoch
  resume impossible; decode parallelism belongs to the wrapped
  iterator's own workers (``ImageRecordIter``).
- **per-read timeout** — ``next()`` raises :class:`DataTimeoutError`
  instead of blocking forever on a hung read.
- **retry with backoff** — a transient ``OSError`` (one carrying an
  ``errno``) is retried with bounded exponential backoff before it
  propagates.
- **bad-record policy** — a corrupt record (a decode error, an
  ``errno``-less ``IOError`` such as RecordIO's bad magic) raises
  (``on_bad_record="raise"``) or is skipped against a per-epoch
  ``skip_budget``; every such record goes into the quarantine log
  (sequence number, file offset where the error has one, the error).
- **worker-death detection** — a prefetch worker that dies without a
  message is found by the consumer's liveness probe and respawned, at
  most ``max_respawns`` times, then :class:`WorkerDiedError`.
- **iterator-state protocol** — ``state_dict()``/``load_state_dict()``:
  epoch, batches delivered and the wrapped iterator's epoch-start state,
  so ``TrainStep.save_checkpoint(..., data_iter=it)`` resumes at the
  exact next batch (the delivered batches are replayed, or fast-forwarded
  by the wrapped iterator itself, with the same shuffle and the same
  skips).  The state is the JAX package's: either package's state loads
  into the other's iterator.

Every read goes through the module-level :func:`_pull`, so the fault
harness (``parallel/fault_injection.py``: ``flaky_reads``,
``slow_reads``, ``kill_worker``) can put failures in its place.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import warnings
import weakref
from typing import Any, Dict, List, Optional

from .io import (DataIter, _check_state_kind, _CurrentBatchConsumer,
                 _drain_join_drain, _stop_aware_put)

__all__ = ["ResilientIter", "DataTimeoutError", "SkipBudgetExceeded",
           "WorkerDiedError"]

#: consumer-side liveness/deadline poll period (seconds)
_POLL = 0.02


class DataTimeoutError(IOError):
    """No batch arrived within the configured per-read timeout (hung
    read: NFS stall, dead disk, wedged decoder)."""


class SkipBudgetExceeded(IOError):
    """More bad records than ``skip_budget`` allows in one epoch — the
    data is too damaged to silently skip through."""


class WorkerDiedError(IOError):
    """The prefetch worker died without reporting and the bounded
    respawn budget is spent."""


def _pull(next_fn):
    """Fetch one item from the wrapped iterator.  Module-level so the
    fault harness (``parallel/fault_injection.py``) can interpose
    flaky/slow/killed reads — same pattern as the checkpoint module's
    ``_write_bytes``."""
    return next_fn()


def _is_transient(exc: BaseException) -> bool:
    """Transient infra fault (worth retrying) vs corrupt data (never
    retried: a decode error is deterministic).  Transient == an
    ``OSError`` carrying an ``errno`` (EIO, EAGAIN, ETIMEDOUT, ...);
    the corrupt-record ``IOError`` s recordio raises are ``errno``-less
    and carry ``path``/``offset`` attributes instead.

    A per-batch error surfaced by a threaded record iterator
    (``_mxtpu_batch_error``) is NEVER transient regardless of errno:
    the inner already consumed that batch slot, so a retry would pull
    the NEXT batch in its place — the failed batch would vanish
    unquarantined and the consumed-count bookkeeping would shift by
    one, breaking bit-identical resume."""
    if getattr(exc, "_mxtpu_batch_error", False):
        return False
    return (isinstance(exc, OSError)
            and getattr(exc, "errno", None) is not None
            and not isinstance(exc, (DataTimeoutError, WorkerDiedError,
                                     SkipBudgetExceeded)))


class ResilientIter(_CurrentBatchConsumer, DataIter):
    """Fault-tolerant prefetching wrapper around any ``DataIter`` or
    (re-)iterable.

    Parameters
    ----------
    data : DataIter or iterable
        The source.  A ``DataIter`` (has ``next``/``reset``) is reset
        per epoch and can skip past a bad record when its own cursor
        already advanced (indexed record readers reseek); a plain
        iterable is re-``iter()``-ed per epoch, and a generator that
        raises is dead by Python's rules — its epoch ends at the bad
        record.
    prefetch : int
        Queue depth of the background prefetch (bounded; producer
        blocks when the consumer falls behind).
    timeout : float or None
        Per-read timeout in seconds for ``next()``; ``None`` waits
        forever.  A timeout raises :class:`DataTimeoutError` — the read
        is NOT retried (the hung worker still holds the iterator
        mid-call; retrying would double-advance a stateful stream).
    retries, backoff : int, float
        Bounded retry-with-exponential-backoff for transient
        ``OSError`` s (the ``CheckpointManager`` backoff shape).
    on_bad_record : "skip" | "raise"
        Corrupt/undecodable record policy.  ``"skip"`` quarantines and
        continues within ``skip_budget`` per epoch; ``"raise"``
        quarantines and propagates.
    skip_budget : int
        Max skipped records per epoch before
        :class:`SkipBudgetExceeded`.
    quarantine_log : str or None
        Optional path; every quarantined record appends one JSON line
        (also kept in-memory as ``self.quarantine``).
    max_respawns : int
        How many silently-died prefetch workers to replace before
        :class:`WorkerDiedError`.
    """

    def __init__(self, data, prefetch=2, timeout=None, retries=2,
                 backoff=0.05, on_bad_record="raise", skip_budget=16,
                 quarantine_log=None, max_respawns=2):
        if on_bad_record not in ("skip", "raise"):
            raise ValueError("on_bad_record must be 'skip' or 'raise', "
                             "got %r" % (on_bad_record,))
        if int(prefetch) < 1:
            raise ValueError("prefetch must be >= 1")
        super().__init__(getattr(data, "batch_size", 0))
        self._source = data
        self._is_data_iter = hasattr(data, "next") and hasattr(data, "reset")
        self._prefetch = int(prefetch)
        self.timeout = None if timeout is None else float(timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.on_bad_record = on_bad_record
        self.skip_budget = int(skip_budget)
        self.max_respawns = int(max_respawns)
        self._qlog_path = quarantine_log
        if quarantine_log:
            d = os.path.dirname(quarantine_log)
            if d:
                os.makedirs(d, exist_ok=True)
        self.quarantine: List[Dict[str, Any]] = []
        self._qlock = threading.Lock()
        self._q: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._respawns = 0
        self._epoch = -1
        self._consumed = 0
        self._skipped_epoch = 0
        self._seq = 0  # records pulled this epoch (quarantine key)
        self._next_fn = None
        self._inner_state0 = None  # wrapped iter's epoch-START snapshot
        self._closed = False
        self.current_batch = None
        # consumption-accurate skip accounting (see state_dict): skip
        # count / quarantine length as of the last DELIVERED batch —
        # read-ahead skips the training loop never moved past must not
        # be checkpointed, or a resume re-quarantines them
        self._acct_skipped = 0
        self._acct_qlen = 0
        self.reset()

    # -- pass-throughs ---------------------------------------------------
    @property
    def provide_data(self):
        return getattr(self._source, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._source, "provide_label", None)

    # -- epoch / shutdown ------------------------------------------------
    def reset(self):
        self._shutdown_worker()
        self._closed = False
        if self._is_data_iter:
            self._source.reset()
            self._next_fn = self._source.next
        else:
            it = iter(self._source)
            self._next_fn = lambda: next(it)
        self._epoch += 1
        self._consumed = 0
        self._skipped_epoch = 0
        self._seq = 0
        self._respawns = 0
        self.current_batch = None
        self._acct_skipped = 0
        self._acct_qlen = len(self.quarantine)  # prior epochs stay accounted
        self._inner_state0 = self._snapshot_inner()
        self._start_worker()

    def _snapshot_inner(self):
        """The wrapped iterator's state at the START of this epoch —
        taken before any prefetch pull, so it is consumption-accurate
        (the live inner races ahead of the consumer by up to
        ``prefetch`` batches and its live state is NOT checkpointable).
        """
        sd = getattr(self._source, "state_dict", None)
        if sd is None:
            return None
        try:
            return sd()
        except NotImplementedError:
            return None

    def close(self, join_timeout=5):
        """Stop and JOIN the prefetch worker (idempotent).  Thread count
        after close() equals the count before construction — the leak
        check ``tests/test_resilient_io.py`` pins."""
        self._closed = True
        self._shutdown_worker(join_timeout)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _shutdown_worker(self, join_timeout=5):
        _drain_join_drain(self._q, self._stop, self._thread, join_timeout)
        self._thread = None

    # -- producer --------------------------------------------------------
    def _start_worker(self):
        self._errored = False
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._spawn()

    def _spawn(self):
        self._thread = threading.Thread(
            target=self._worker_main,
            args=(weakref.ref(self), self._q, self._stop),
            daemon=True, name="ResilientIter-prefetch")
        self._thread.start()

    @staticmethod
    def _worker_main(wref, q, stop):
        """Producer main.  Holds the iterator only through a weakref,
        resolved per pull and dropped before every (possibly blocking)
        put: an abandoned ResilientIter — no close(), loop just broke —
        stays collectable, so its __del__ joins this thread instead of
        the put loop spinning forever against a consumer that no
        longer exists."""
        while not stop.is_set():
            owner = wref()
            if owner is None:
                return
            try:
                kind, payload = owner._fetch_one(stop=stop)
            except Exception as e:  # policy says propagate
                del owner
                _stop_aware_put(q, stop, ("err", e), wref)
                return
            if kind == "skip":
                del owner
                continue
            if kind == "item":
                # tag with the skip accounting AS OF this item: only the
                # state of batches the consumer actually received may be
                # checkpointed (read-ahead skips re-happen on resume)
                payload = (payload, owner._skipped_epoch,
                           len(owner.quarantine))
            del owner
            if not _stop_aware_put(q, stop, (kind, payload), wref):
                return
            if kind == "end":
                return
        # a BaseException from _fetch_one (injected SystemExit, real
        # thread death) escapes: the thread dies without a message and
        # the consumer's liveness probe respawns a replacement

    def _fetch_one(self, log=True, stop=None, force_skips=frozenset()):
        """One pull through the full fault policy: transient retry with
        backoff, bad-record quarantine + skip budget.  Returns
        ``("item", x)`` / ``("skip", None)`` / ``("end", None)``;
        raises when the policy says the caller must see the fault.
        Used by the prefetch worker AND (with ``log=False``) by the
        synchronous resume replay, so both paths skip identically.

        ``stop`` — the worker's epoch-local stop event: a stale worker
        whose hung read outlived the shutdown join timeout returns from
        the pull AFTER the next epoch started — it must abandon without
        touching the (now next epoch's) shared accounting.

        ``force_skips`` — resume-replay only: seqs the original run
        quarantined.  A still-corrupt one skips regardless of policy
        (a ``"raise"`` run continued past it once; the replay must
        too, or the checkpoint is unrestorable) without re-logging or
        re-charging the skip budget — the restored quarantine already
        accounts for it."""
        attempt = 0
        while True:
            if stop is not None and stop.is_set():
                # stale worker woke from a retry backoff after reset():
                # self._next_fn is already rebound to the NEXT epoch's
                # stream — pulling would steal its records
                return ("end", None)
            seq = self._seq
            try:
                item = _pull(self._next_fn)
            except StopIteration:
                return ("end", None)
            except Exception as e:
                if stop is not None and stop.is_set():
                    return ("end", None)  # stale: mutate nothing
                if _is_transient(e):
                    # the CheckpointManager backoff shape: bounded,
                    # exponential, last failure propagates
                    if attempt >= self.retries:
                        raise
                    time.sleep(self.backoff * (2 ** attempt))
                    attempt += 1
                    continue
                # corrupt/undecodable record: deterministic, never
                # retried — quarantine and apply the skip policy
                self._seq += 1
                if seq in force_skips:
                    return ("skip", None)
                self._quarantine_record(seq, e, log=log)
                if self.on_bad_record == "raise":
                    raise
                self._skipped_epoch += 1
                if self._skipped_epoch > self.skip_budget:
                    raise SkipBudgetExceeded(
                        "skipped %d bad records this epoch, budget is %d "
                        "(last: %s: %s) — the data is too damaged to "
                        "skip through; see the quarantine log"
                        % (self._skipped_epoch, self.skip_budget,
                           type(e).__name__, e)) from e
                return ("skip", None)
            if stop is not None and stop.is_set():
                return ("end", None)  # stale: mutate nothing
            self._seq += 1
            return ("item", item)

    def _quarantine_record(self, seq, exc, log=True):
        if not log:  # resume replay: already accounted in the first run
            return
        entry = {"seq": int(seq), "epoch": int(self._epoch),
                 "offset": getattr(exc, "offset", None),
                 "path": getattr(exc, "path", None),
                 "error": "%s: %s" % (type(exc).__name__, exc)}
        with self._qlock:
            self.quarantine.append(entry)
            if self._qlog_path:
                try:
                    with open(self._qlog_path, "a") as f:
                        f.write(json.dumps(entry) + "\n")
                except OSError as we:
                    # best-effort: a failing LOG write must not turn a
                    # skippable bad record into a run-killing crash —
                    # the in-memory mirror stays authoritative
                    warnings.warn("quarantine log %s unwritable (%s); "
                                  "entries kept in memory only"
                                  % (self._qlog_path, we))
                    self._qlog_path = None

    # -- consumer --------------------------------------------------------
    def _fetch_next(self):
        if self._closed or self._q is None:
            raise StopIteration
        if self._thread is None and self._q.empty():
            if self._errored:
                # a propagated read error reaped the worker, and the
                # caller chose to continue the epoch (indexed readers
                # can skip past a bad record once their own cursor
                # advanced) — restart the prefetch from wherever the
                # stream stands instead of silently ending the epoch
                self._start_worker()
            else:
                # exhausted: the "end" path joined the worker — keep
                # raising instead of polling a queue nothing will ever
                # fill again
                raise StopIteration
        deadline = None if self.timeout is None \
            else time.monotonic() + self.timeout
        while True:
            try:
                kind, payload = self._q.get(timeout=_POLL)
            except queue.Empty:
                t = self._thread
                if t is not None and not t.is_alive() and self._q.empty():
                    # died without a message (exceptions ARE messages):
                    # bounded respawn continues the pull from wherever
                    # the stream stands
                    if self._respawns >= self.max_respawns:
                        raise WorkerDiedError(
                            "prefetch worker died silently %d time(s); "
                            "respawn budget (%d) spent"
                            % (self._respawns + 1, self.max_respawns))
                    self._respawns += 1
                    self._spawn()
                    continue
                if deadline is not None and time.monotonic() > deadline:
                    raise DataTimeoutError(
                        "no batch within %.3gs (worker %s) — hung read? "
                        "The read is not retried: the worker still holds "
                        "the iterator mid-call" % (
                            self.timeout,
                            "alive but stalled" if t is not None
                            and t.is_alive() else "gone"))
                continue
            if kind == "end":
                self._shutdown_worker()  # reap the producer now
                raise StopIteration
            if kind == "err":
                self._shutdown_worker()
                self._errored = True  # next() after this restarts prefetch
                raise payload
            item, self._acct_skipped, self._acct_qlen = payload
            self._consumed += 1
            return item

    # -- iterator-state protocol ----------------------------------------
    def state_dict(self):
        """Consumption-accurate position: epoch, batches DELIVERED to
        the caller (the prefetch read-ahead is re-produced on resume),
        the wrapped iterator's epoch-start snapshot, and the quarantine
        accounting AS OF the last delivered batch — skips the worker's
        read-ahead already logged but the loop never moved past are
        excluded (they re-happen, and re-log, on resume)."""
        st = {"iter": type(self).__name__, "epoch": int(self._epoch),
              "consumed": int(self._consumed),
              "skipped": int(self._acct_skipped),
              "quarantine": list(self.quarantine[:self._acct_qlen])}
        if self._inner_state0 is not None:
            st["inner"] = self._inner_state0
        elif self._is_data_iter:
            # without inner state, load_state_dict falls back to
            # reset()-and-replay from batch 0 — correct ONLY if reset()
            # reproduces the same order (no reshuffle).  Silent
            # degradation here is how a resumed run diverges with
            # plausible losses, so say it at SAVE time
            warnings.warn(
                "wrapped %s has no state_dict(): the checkpoint carries "
                "only the consumed-batch cursor, and resume will reset() "
                "it and replay from batch 0.  If reset() reshuffles, the "
                "resumed batch order silently diverges from the "
                "uninterrupted run — implement state_dict/"
                "load_state_dict on the inner iterator for exact "
                "mid-epoch resume" % type(self._source).__name__,
                RuntimeWarning, stacklevel=2)
        return st

    def load_state_dict(self, state):
        _check_state_kind(state, type(self).__name__)
        self._shutdown_worker()
        self._closed = False
        target = int(state["consumed"])
        # seqs the original run quarantined this epoch are force-skipped
        # by the replay even when the fault does not reproduce (a
        # once-transient per-batch error reads fine on replay) —
        # counting such a record would shift every later batch by one
        # versus the uninterrupted run
        replay_skips = {int(q["seq"]) for q in state.get("quarantine", [])
                        if int(q.get("epoch", -1)) == int(state["epoch"])}
        fast_forwarded = False
        inner_st = state.get("inner")
        if inner_st is not None:
            load = getattr(self._source, "load_state_dict", None)
            if load is None:
                raise ValueError(
                    "checkpointed iterator state carries inner-iterator "
                    "state but %r has no load_state_dict"
                    % type(self._source).__name__)
            if (target and not replay_skips
                    and not int(state.get("skipped", 0))
                    and isinstance(inner_st.get("batch"), int)):
                # clean-epoch fast path: no slot was skipped, so one
                # inner slot == one delivered batch and the inner's OWN
                # fast-forward (ImageRecordIter: replays RNG draws,
                # skips reads/decodes entirely) lands on exactly the
                # position a pull-by-pull replay would — without
                # re-decoding every pre-crash batch
                load(dict(inner_st, batch=target))
                fast_forwarded = True
            else:
                load(inner_st)
            self._next_fn = self._source.next
            self._inner_state0 = inner_st
        else:
            # stateless inner: re-iterate from the top and rely on the
            # replay below (valid for re-iterables; a one-shot
            # generator cannot be resumed and fails the replay length
            # check)
            if self._is_data_iter:
                self._source.reset()
                self._next_fn = self._source.next
            else:
                it = iter(self._source)
                self._next_fn = lambda: next(it)
            self._inner_state0 = None
        self._epoch = int(state["epoch"])
        self._seq = 0
        self._consumed = 0
        self._skipped_epoch = 0
        self._respawns = 0
        if fast_forwarded:
            self._consumed = self._seq = target
        else:
            self._replay_to(target, replay_skips)
        self.quarantine = list(state.get("quarantine", []))
        self._skipped_epoch = int(state.get("skipped", 0))
        self._acct_skipped = self._skipped_epoch
        self._acct_qlen = len(self.quarantine)
        self.current_batch = None
        self._start_worker()

    def _replay_loop(self, target, replay_skips, stop=None):
        """Deterministic fast-forward to the consumed position: same
        pulls, same skips (unlogged — they are already accounted for
        in the restored quarantine), so the next delivered batch is
        EXACTLY the one after the last pre-crash batch.

        ``stop`` — set by a timed-out :meth:`_replay_to`: the abandoned
        replay thread must exit without touching the shared cursor the
        moment its hung read returns (same contract as a stale prefetch
        worker)."""
        while self._consumed < target:
            if stop is not None and stop.is_set():
                return  # abandoned: mutate nothing
            seq = self._seq
            kind, _ = self._fetch_one(log=False, stop=stop,
                                      force_skips=replay_skips)
            if kind == "end":
                if stop is not None and stop.is_set():
                    return
                raise ValueError(
                    "wrapped iterator exhausted after %d of %d replayed "
                    "batches — resume needs the same dataset the "
                    "checkpoint was written against"
                    % (self._consumed, target))
            if kind == "item" and seq not in replay_skips:
                self._consumed += 1

    def _replay_to(self, target, replay_skips):
        """Run the resume replay with the per-read timeout enforced: a
        hung read during restore must surface as
        :class:`DataTimeoutError`, not block ``restore_checkpoint``
        forever — the same contract ``next()`` honors."""
        if self.timeout is None:
            self._replay_loop(target, replay_skips)
            return
        box = []
        done = threading.Event()
        stop = threading.Event()

        def run():
            try:
                self._replay_loop(target, replay_skips, stop)
            except BaseException as e:
                box.append(e)
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="ResilientIter-replay")
        t.start()
        last = -1
        deadline = time.monotonic() + self.timeout
        while not done.wait(_POLL):
            if self._seq != last:  # a pull completed: reset the clock
                last = self._seq
                deadline = time.monotonic() + self.timeout
            elif time.monotonic() > deadline:
                stop.set()  # abandoned thread mutates nothing on wake
                warnings.warn(
                    "resume replay abandoned after %.3gs without a "
                    "batch; the replay thread may still hold the "
                    "wrapped iterator mid-read — reset() or rebuild "
                    "the iterator before retrying the restore"
                    % self.timeout, RuntimeWarning)
                raise DataTimeoutError(
                    "no batch within %.3gs during the resume replay "
                    "(%d of %d batches fast-forwarded) — hung read? "
                    "The read is not retried: the replay thread still "
                    "holds the iterator mid-call"
                    % (self.timeout, self._consumed, target))
        if box:
            raise box[0]
