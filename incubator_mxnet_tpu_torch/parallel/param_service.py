"""The bounded-staleness asynchronous parameter service (port of
``incubator_mxnet_tpu/parallel/param_service.py``; ps-lite's asynchronous
push/pull kvstore, ``kvstore_dist_server.h``).

Three pieces, each testable alone:

- :class:`ParamService` — the server: the authoritative parameters, a
  server-side optimizer (:class:`ServiceUpdater` over the train step's
  :class:`~.train_step.FunctionalOptimizer`) and the bounded-staleness
  clock (:class:`StalenessClock`).  A rank may run up to
  ``staleness_bound`` steps ahead of the slowest live peer before its
  pull blocks; ``staleness_bound=0`` is BSP.  Keys are spread over
  ``num_shards`` server shards by crc32 (push volume is counted per
  shard).  :meth:`ParamService.register`/:meth:`~ParamService.deregister`
  let ranks join and leave: a departed straggler stops holding the
  bound.
- :class:`ServiceClient` — the rank's side: pushes go through an
  error-feedback compressor (``kvstore/gradient_compression.py``) and
  are decompressed by the service from the self-describing payload.
  ``state_dict()``/``load_state_dict()`` carry the compressor's residuals,
  the sparse step counters and, when the client owns its service, the
  whole server state and clock, so kill-and-resume is bit-identical.
- :class:`SyncPolicy` — the sync→async ladder: under ``mode="auto"`` the
  supervisor's straggler verdicts degrade the step from allreduce to
  async push/pull after ``degrade_after`` observations in a row with a
  straggler, and recover after ``recover_after`` clean ones.

Every push and pull goes through the module-level :func:`_deliver_push` /
:func:`_deliver_pull`, where the fault harness interposes a slow link or
lost pushes (``fault_injection.slow_link``/``drop_push``).

The service lives in the process of the rank that owns it (threads may
share it); the parameters stay tensors on their device.  Ranks in other
processes reach a parameter host through ``kvstore/async_host.py``.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["ParamService", "ServiceClient", "ServiceUpdater",
           "StalenessClock", "SyncPolicy", "StalenessTimeout"]


class StalenessTimeout(RuntimeError):
    """A bounded-staleness pull waited past its deadline: the slowest
    live peer never caught up (a hung rank that nothing deregistered)."""


def _copy(value) -> torch.Tensor:
    """A tensor copy of ``value`` (a tensor, an NDArray or an array) that
    shares no memory with it."""
    from ..kvstore.gradient_compression import _as_tensor

    return _as_tensor(value).detach().clone()


class StalenessClock:
    """Per-rank committed-push counts over the set of live ranks.

    ``staleness(rank) = count[rank] - min(live counts)``: how far this
    rank has run ahead of the slowest live peer.  Not thread-safe by
    itself; the service holds its lock around it."""

    def __init__(self):
        self._count: Dict[int, int] = {}
        self._live: Dict[int, bool] = {}

    def register(self, rank: int, at_step: Optional[int] = None) -> None:
        """Join (or join again) at ``at_step``; by default at the current
        minimum, so a new rank neither blocks on day-one staleness nor
        releases its peers early."""
        if rank not in self._count or at_step is not None:
            self._count[rank] = int(at_step) if at_step is not None \
                else self.min_step()
        self._live[rank] = True

    def deregister(self, rank: int) -> None:
        self._live[rank] = False

    def advance(self, rank: int) -> int:
        self._count[rank] = self._count.get(rank, 0) + 1
        return self._count[rank]

    def step(self, rank: int) -> int:
        return self._count.get(rank, 0)

    def live_ranks(self) -> List[int]:
        return sorted(r for r, ok in self._live.items() if ok)

    def min_step(self) -> int:
        live = [self._count[r] for r, ok in self._live.items() if ok]
        return min(live) if live else 0

    def staleness(self, rank: int) -> int:
        return self.step(rank) - self.min_step()

    def state_dict(self) -> Dict[str, Dict[str, np.int64]]:
        return {"count": {str(r): np.int64(c)
                          for r, c in sorted(self._count.items())},
                "live": {str(r): np.int64(1 if ok else 0)
                         for r, ok in sorted(self._live.items())}}

    def load_state_dict(self, state: Dict) -> None:
        self._count = {int(r): int(c)
                       for r, c in dict(state["count"]).items()}
        self._live = {int(r): bool(int(v))
                      for r, v in dict(state["live"]).items()}


class ServiceUpdater:
    """The server-side optimizer: one
    :class:`~.train_step.FunctionalOptimizer` state per key, applied per
    push (ps-lite's async ``ApplyUpdates``: every push is an update of
    its own; no barrier across the ranks)."""

    def __init__(self, optimizer=None):
        if optimizer is None:
            from .train_step import FunctionalOptimizer

            optimizer = FunctionalOptimizer("sgd", learning_rate=0.01,
                                            momentum=0.0)
        self.opt = optimizer
        self._state: Dict[str, Any] = {}
        self._count: Dict[str, int] = {}

    def init_key(self, key: str, value) -> None:
        if key in self._count:
            return
        self._count[key] = 0
        if self.opt.has_state:
            self._state[key] = self.opt.init([_copy(value)])[0]

    def apply(self, key: str, weight, grad):
        """One update, ``(weight, grad) -> new weight``, with the key's
        state and its 1-based count (an int32 tensor on the weight's
        device, as the train step passes its count).  A positional key
        (``"3"``) is the optimizer's index, as in the train step."""
        self._count[key] = self._count.get(key, 0) + 1
        s = self._state.get(key) if self.opt.has_state else None
        count = torch.tensor(self._count[key], dtype=torch.int32,
                             device=weight.device)
        index = int(key) if str(key).isdigit() else None
        with torch.no_grad():
            w2, s2 = self.opt.apply_single(weight, grad, s, count, index)
        if self.opt.has_state:
            self._state[key] = s2
        return w2

    def state_dict(self) -> Dict:
        return {"count": {k: np.int64(v)
                          for k, v in sorted(self._count.items())},
                "state": {k: self._state[k] for k in sorted(self._state)}}

    def load_state_dict(self, state: Dict) -> None:
        self._count = {str(k): int(v)
                       for k, v in dict(state["count"]).items()}
        self._state = {str(k): v for k, v in dict(state["state"]).items()}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


def _payload_nbytes(payload) -> int:
    """Wire bytes of one push payload (a compressed dict or a dense
    tensor)."""
    if isinstance(payload, dict):
        return sum(_nbytes(v) for v in payload.values()
                   if isinstance(v, (torch.Tensor, np.ndarray)))
    return _nbytes(payload)


def _dense_nbytes(payload, dense) -> int:
    """What the push would cost uncompressed."""
    if isinstance(payload, dict):
        from ..base import torch_dtype

        dtype = torch_dtype(str(payload["dtype"]))
        itemsize = torch.empty((), dtype=dtype).element_size()
        return int(np.prod(payload["shape"], dtype=np.int64)) * itemsize
    return _nbytes(dense)


# ---------------------------------------------------------------------------
# the transport's choke points: the fault harness interposes here
# (fault_injection.slow_link / drop_push), as at supervisor._run_step
# ---------------------------------------------------------------------------

def _deliver_push(service: "ParamService", rank: int, updates: Dict):
    """The one path every push takes from a client into the service."""
    return service._apply_push(rank, updates)


def _deliver_pull(service: "ParamService", rank: int,
                  timeout: Optional[float]):
    """The one path every pull takes; the blocking happens inside."""
    return service._collect_pull(rank, timeout)


class ParamService:
    """The bounded-staleness parameter server of one process
    (thread-safe)."""

    def __init__(self, updater: Optional[ServiceUpdater] = None,
                 staleness_bound: int = 4, num_shards: int = 1):
        if int(staleness_bound) < 0:
            raise ValueError("staleness_bound must be >= 0, got %r"
                             % (staleness_bound,))
        if int(num_shards) < 1:
            raise ValueError("num_shards must be >= 1, got %r"
                             % (num_shards,))
        self.staleness_bound = int(staleness_bound)
        self.num_shards = int(num_shards)
        self.updater = updater or ServiceUpdater()
        self.clock = StalenessClock()
        self._params: Dict[str, torch.Tensor] = {}
        self._versions: Dict[str, int] = {}
        self._cv = threading.Condition()
        self.max_observed_staleness = 0   # over every pull served
        self.push_nbytes = 0              # wire bytes pushed
        self.push_dense_nbytes = 0        # what uncompressed would cost
        self.shard_push_nbytes = [0] * self.num_shards
        self.pulls_blocked = 0            # pulls that had to wait

    # -- membership -----------------------------------------------------
    def register(self, rank: int, at_step: Optional[int] = None) -> None:
        with self._cv:
            self.clock.register(rank, at_step)
            self._cv.notify_all()

    def deregister(self, rank: int) -> None:
        """A departed rank stops counting toward the staleness minimum;
        the waiters look again at once."""
        with self._cv:
            self.clock.deregister(rank)
            self._cv.notify_all()

    # -- key space ------------------------------------------------------
    def shard_of(self, key: str) -> int:
        return zlib.crc32(str(key).encode()) % self.num_shards

    def init(self, key: str, value) -> None:
        """The first value of a key sticks (kvstore ``init``: rank 0
        wins); later inits do nothing.  The service keeps its own copy."""
        with self._cv:
            if key not in self._params:
                self._params[key] = _copy(value)
                self._versions[key] = 0
                self.updater.init_key(key, value)

    def sync_params(self, named_values: Dict) -> None:
        """Overwrite the authoritative parameters with copies of these
        values: a sync→async degrade hands the service the collective
        rung's current state."""
        with self._cv:
            for key, v in named_values.items():
                if key not in self._params:
                    raise KeyError("sync_params to uninitialized key %r"
                                   % (key,))
                self._params[key] = _copy(v)
                self._versions[key] += 1
            self._cv.notify_all()

    def keys(self) -> List[str]:
        with self._cv:
            return sorted(self._params)

    # -- push/pull (through the module's choke points) ------------------
    def push(self, rank: int, updates: Dict, commit: bool = True):
        """Apply one step's (possibly compressed) gradient payloads, ``{key:
        dense tensor or payload dict}``, and advance the pusher's
        clock."""
        return _deliver_push(self, rank, updates) if commit \
            else self._apply_push(rank, updates, commit=False)

    def pull(self, rank: int, timeout: Optional[float] = None) -> Dict:
        """Every parameter, blocking while this rank's staleness exceeds
        ``staleness_bound``; raises :class:`StalenessTimeout` after
        ``timeout`` seconds (None: no limit).  The bound is observable
        as :attr:`max_observed_staleness`."""
        return _deliver_pull(self, rank, timeout)

    def _apply_push(self, rank: int, updates: Dict, commit: bool = True):
        from ..kvstore.gradient_compression import decompress_payload

        dense = {k: decompress_payload(v) for k, v in updates.items()}
        with self._cv:
            for key, g in dense.items():
                if key not in self._params:
                    raise KeyError("push to uninitialized key %r" % (key,))
                w = self._params[key]
                self._params[key] = self.updater.apply(
                    key, w, g.to(w.device))
                self._versions[key] += 1
                nb = _payload_nbytes(updates[key])
                self.push_nbytes += nb
                self.push_dense_nbytes += _dense_nbytes(updates[key], g)
                self.shard_push_nbytes[self.shard_of(key)] += nb
            if commit:
                self.clock.advance(rank)
                self._cv.notify_all()

    def _collect_pull(self, rank: int, timeout: Optional[float]):
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            waited = False
            while self.clock.staleness(rank) > self.staleness_bound:
                if not waited:
                    self.pulls_blocked += 1
                    waited = True
                remaining = None if end is None else end - time.monotonic()
                if (remaining is not None and remaining <= 0) or \
                        not self._cv.wait(timeout=remaining):
                    raise StalenessTimeout(
                        "rank %d pull blocked > %.1fs at staleness %d "
                        "(bound %d; live ranks %s, clock %s) — a hung "
                        "peer nothing deregistered"
                        % (rank, timeout, self.clock.staleness(rank),
                           self.staleness_bound, self.clock.live_ranks(),
                           {r: self.clock.step(r)
                            for r in self.clock.live_ranks()}))
            obs = self.clock.staleness(rank)
            if obs > self.max_observed_staleness:
                self.max_observed_staleness = obs
            return dict(self._params)

    # -- checkpoint protocol --------------------------------------------
    def state_dict(self) -> Dict:
        with self._cv:
            return {"params": {k: self._params[k]
                               for k in sorted(self._params)},
                    "versions": {k: np.int64(self._versions[k])
                                 for k in sorted(self._versions)},
                    "clock": self.clock.state_dict(),
                    "updater": self.updater.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        with self._cv:
            self._params = {str(k): _copy(v)
                            for k, v in dict(state["params"]).items()}
            self._versions = {str(k): int(v)
                              for k, v in dict(state["versions"]).items()}
            self.clock.load_state_dict(state["clock"])
            self.updater.load_state_dict(state["updater"])
            self._cv.notify_all()


class ServiceClient:
    """A rank's push/pull glue: compression with error feedback on the
    push path, checkpointed with the train step that owns it."""

    def __init__(self, service: ParamService, rank: int = 0,
                 compressor=None, owns_service: bool = False):
        self.service = service
        self.rank = int(rank)
        self.compressor = compressor
        self._owns_service = bool(owns_service)
        service.register(self.rank)

    def init_params(self, named_values: Dict) -> None:
        """Seed the server (rank 0 wins) and make every residual slot now,
        so the checkpoint's tree is the same from the start: a resume
        before the first push sees the tree a later save wrote."""
        from ..kvstore.gradient_compression import _as_tensor

        for k, v in named_values.items():
            self.service.init(k, v)
            if self.compressor is not None:
                res = self.compressor._residual
                if k not in res:
                    res[k] = torch.zeros_like(_as_tensor(v))
                if hasattr(self.compressor, "_step_of"):
                    self.compressor._step_of.setdefault(k, 0)

    def sync_params(self, named_values: Dict) -> None:
        """Force the server's parameters to these values (the handover
        from the collective rung at a degrade)."""
        self.service.sync_params(named_values)

    def push_step(self, grads: Dict) -> None:
        """One step's gradients, compressed when set, into the service;
        advances this rank's clock once."""
        if self.compressor is not None:
            payloads = {k: self.compressor.compress(k, g)
                        for k, g in grads.items()}
        else:
            payloads = dict(grads)
        self.service.push(self.rank, payloads)

    def pull_params(self, timeout: Optional[float] = None) -> Dict:
        return self.service.pull(self.rank, timeout=timeout)

    def leave(self) -> None:
        self.service.deregister(self.rank)

    # -- checkpoint protocol -------------------------------------------
    def state_dict(self) -> Dict:
        comp = {} if self.compressor is None \
            else self.compressor.state_dict()
        out = {"compressor": comp,
               "rank_step": np.int64(self.service.clock.step(self.rank))}
        if self._owns_service:
            out["service"] = self.service.state_dict()
        return out

    def load_state_dict(self, state: Dict) -> None:
        state = dict(state)
        if self.compressor is not None and state.get("compressor"):
            self.compressor.load_state_dict(state["compressor"])
        if self._owns_service and "service" in state:
            self.service.load_state_dict(state["service"])
        else:
            # join again at the saved position: the clock survives the
            # kill even where the service outlived this rank
            self.service.register(self.rank,
                                  at_step=int(state["rank_step"]))


class SyncPolicy:
    """The sync→async ladder as a state machine.

    ``mode="allreduce"``/``"async"`` pin the rung; ``"auto"`` starts at
    allreduce, switches to async push/pull after ``degrade_after``
    observations in a row with a straggler, and back after
    ``recover_after`` clean observations in a row: one noisy heartbeat
    frame does not flap the step between the collectives and the
    service."""

    def __init__(self, mode: str = "auto", degrade_after: int = 2,
                 recover_after: int = 8):
        if mode not in ("auto", "allreduce", "async"):
            raise ValueError("sync mode must be 'auto', 'allreduce' or "
                             "'async', got %r" % (mode,))
        if int(degrade_after) < 1 or int(recover_after) < 1:
            raise ValueError("degrade_after/recover_after must be >= 1")
        self.mode = mode
        self.degrade_after = int(degrade_after)
        self.recover_after = int(recover_after)
        self.effective = "async" if mode == "async" else "allreduce"
        self._dirty = 0
        self._clean = 0
        #: (observation index, new effective mode) of every switch
        self.transitions: List = []
        self._seen = 0

    def observe(self, straggler_ranks) -> str:
        """One frame of straggler verdicts; returns the effective mode
        after it."""
        self._seen += 1
        if self.mode != "auto":
            return self.effective
        if straggler_ranks:
            self._dirty += 1
            self._clean = 0
        else:
            self._clean += 1
            self._dirty = 0
        if self.effective == "allreduce" and \
                self._dirty >= self.degrade_after:
            self.effective = "async"
            self.transitions.append((self._seen, "async"))
        elif self.effective == "async" and \
                self._clean >= self.recover_after:
            self.effective = "allreduce"
            self.transitions.append((self._seen, "allreduce"))
        return self.effective
