"""Fault injection for the training side of the resilience layer (port of
``incubator_mxnet_tpu/parallel/fault_injection.py``, its training half).

Deterministic injectors for the failures the port's training path must
survive:

- **bad numerics** — :func:`poison_batch` / :class:`NaNInjector` plant a
  NaN (or inf) in a chosen step's batch; it reaches every gradient, as a
  corrupt record or an overflow does;
- **failed writes** — :func:`fail_writes` makes the checkpoint writer
  (``checkpoint._write_bytes``) raise ``OSError`` on chosen writes:
  transient (the retry must absorb it) or persistent (a failed save must
  leave the last committed checkpoint intact);
- **silent corruption** — :func:`corrupt_checkpoint` flips a bit in or
  truncates a committed file, or tears the manifest;
  :func:`corrupt_compile_cache` damages a compile-cache entry (the built
  kernel library, ``parallel/aot.py`` ``CompileCache``);
- **input faults** — :func:`flaky_reads`, :func:`slow_reads` and
  :func:`kill_worker` interpose the resilient loader's record puller
  (``io/resilient.py::_pull``) with transient errnos, latency and a
  worker's silent death; :func:`truncate_record` tears a record file as
  a crash mid-write does;
- **host loss** — :func:`kill_process` is a real ungraceful death
  (SIGKILL), :func:`host_loss_during_save` arms it on a chosen checkpoint
  write so a rank dies mid-stage (the torn multi-process checkpoint the
  commit must never publish), :func:`coordinator_unreachable` makes the
  rendezvous (``distributed._raw_initialize``) fail as a dead coordinator
  does, and :func:`straggler_process` delays this process's done-marker;
- **supervised training** — :func:`hang_step` wedges the supervised step
  call (``supervisor._run_step``) and :func:`loss_bomb` scales the
  parameters there, a finite explosion only a rollback heals;
- **the parameter service** — :func:`slow_link` delays a rank's pushes
  and pulls and :func:`drop_push` loses push payloads, at the service's
  transport choke points (``param_service._deliver_push``/
  ``_deliver_pull``);
- **requests** — :func:`malformed_request` builds payloads the batcher
  must reject one by one, :func:`slow_client` stalls admission
  (``serve/batcher.py::_admit``), :func:`burst_arrivals` submits a
  thundering herd and :func:`deadline_storm` a burst whose SLO deadlines
  expire in the queue;
- **serving chaos** — :func:`kill_batcher_worker` kills the batcher's
  worker mid-batch and :func:`engine_failure_burst` makes engine
  executions raise, both at ``serve/batcher.py::_serve_batch``;
  :func:`nan_params` builds a poisoned hot-swap candidate and
  :func:`swap_storm` fires canaried swaps from a thread under the
  caller's traffic, one of them poisoned if asked.

Everything here is process-local patching or file surgery, except
:func:`kill_process`, which only a spawned rank should call.
"""
from __future__ import annotations

import errno as _errno
import os
import signal as _signal
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

__all__ = ["NaNInjector", "burst_arrivals", "coordinator_unreachable",
           "corrupt_checkpoint", "deadline_storm", "drop_push",
           "engine_failure_burst", "fail_writes", "flaky_reads",
           "hang_step", "host_loss_during_save", "kill_batcher_worker",
           "kill_process", "kill_worker", "loss_bomb", "malformed_request",
           "nan_params", "poison_batch", "slow_client", "slow_link",
           "slow_reads", "straggler_process", "swap_storm",
           "truncate_record"]


def poison_batch(x, value=float("nan"), index=0):
    """Copy of batch ``x`` (an NDArray, a tensor or an array) with
    ``value`` (NaN by default) at flat position ``index``, on ``x``'s
    device: one such element makes every gradient of a dense net
    non-finite."""
    from ..ndarray import NDArray

    if isinstance(x, NDArray):
        return NDArray(poison_batch(x._data, value, index))
    if isinstance(x, torch.Tensor):
        out = x.detach().clone()
        out.view(-1)[index] = value
        return out
    arr = np.array(x)
    arr.reshape(-1)[index] = value
    return arr


class NaNInjector:
    """Wrap a train step so its ``at_steps``-th calls (0-based) see a
    poisoned batch: ``inj = NaNInjector(step, at_steps=(2,))``, then call
    ``inj(x, y)`` in place of ``step(x, y)``.  Every other attribute is
    the step's."""

    def __init__(self, step, at_steps=(0,), value=float("nan")):
        self.step = step
        self.at_steps = set(int(s) for s in at_steps)
        self.value = value
        self.calls = 0

    def __call__(self, x, y):
        if self.calls in self.at_steps:
            x = poison_batch(x, self.value)
        self.calls += 1
        return self.step(x, y)

    def __getattr__(self, name):
        return getattr(self.step, name)


@contextmanager
def _patched_writer(fn):
    """Put ``fn(real_write, path, data)`` in place of
    ``checkpoint._write_bytes`` inside the block."""
    from . import checkpoint as _ckpt

    real = _ckpt._write_bytes
    _ckpt._write_bytes = lambda path, data: fn(real, path, data)
    try:
        yield
    finally:
        _ckpt._write_bytes = real


class _Stats:
    """Counters an injector yields (``seen``, and what it injected)."""

    def __init__(self, **counters):
        self.__dict__.update(counters)


@contextmanager
def fail_writes(at=0, count=1, exc: Optional[BaseException] = None):
    """Make the checkpoint writer raise on chosen file writes: ``count``
    writes from the ``at``-th (0-based, counted inside the block).  The
    default is one transient fault the retry must absorb; a large
    ``count`` is a lasting outage.  Yields counters (``seen``,
    ``failed``)."""
    exc = exc or OSError("injected write failure")
    stats = _Stats(seen=0, failed=0)

    def flaky(real, path, data):
        i = stats.seen
        stats.seen += 1
        if at <= i < at + count:
            stats.failed += 1
            raise exc
        return real(path, data)

    with _patched_writer(flaky):
        yield stats


@contextmanager
def _patched_pull(flaky):
    """Put ``flaky(real_pull, next_fn)`` in place of
    ``io/resilient.py::_pull``, the one call every resilient read makes."""
    from ..io import resilient as _res

    real = _res._pull
    _res._pull = lambda next_fn: flaky(real, next_fn)
    try:
        yield
    finally:
        _res._pull = real


@contextmanager
def flaky_reads(every_k=3, errno=None, count=None):
    """Make every ``every_k``-th resilient read raise a transient
    ``OSError`` (errno EIO by default) before it touches the wrapped
    iterator, so the retry reads the same record and nothing is lost.
    ``count`` bounds the faults (``None``: no bound).  Yields counters
    (``seen``, ``failed``)."""
    eno = _errno.EIO if errno is None else int(errno)
    stats = _Stats(seen=0, failed=0)

    def flaky(real, next_fn):
        i = stats.seen
        stats.seen += 1
        if i % every_k == every_k - 1 and \
                (count is None or stats.failed < count):
            stats.failed += 1
            raise OSError(eno, "injected flaky read (#%d)" % i)
        return real(next_fn)

    with _patched_pull(flaky):
        yield stats


@contextmanager
def slow_reads(latency_s, at=0, count=None):
    """Add ``latency_s`` seconds to the resilient reads from the
    ``at``-th on (``count`` of them; ``None``: all): the hung read a
    per-read timeout must turn into an error.  Yields counters
    (``seen``, ``slowed``)."""
    stats = _Stats(seen=0, slowed=0)

    def slow(real, next_fn):
        i = stats.seen
        stats.seen += 1
        if i >= at and (count is None or stats.slowed < count):
            stats.slowed += 1
            time.sleep(latency_s)
        return real(next_fn)

    with _patched_pull(slow):
        yield stats


@contextmanager
def kill_worker(at=0, count=1):
    """Kill the prefetch worker silently on chosen reads: ``SystemExit``
    (which the read policy's ``except Exception`` does not catch and the
    thread swallows) before the wrapped iterator is touched, so no record
    is lost and the respawned worker goes on where the dead one stood.
    Yields counters (``seen``, ``killed``)."""
    stats = _Stats(seen=0, killed=0)

    def kill(real, next_fn):
        i = stats.seen
        stats.seen += 1
        if at <= i < at + count:
            stats.killed += 1
            raise SystemExit("injected worker death (#%d)" % i)
        return real(next_fn)

    with _patched_pull(kill):
        yield stats


def truncate_record(path, offset):
    """Tear a record file at byte ``offset``, as a crash mid-write does;
    returns the number of bytes cut off."""
    size = os.path.getsize(path)
    if not 0 <= offset < size:
        raise ValueError("offset %d outside file %r (size %d)"
                         % (offset, path, size))
    with open(path, "r+b") as f:
        f.truncate(int(offset))
    return size - int(offset)


def corrupt_checkpoint(directory, step=None, what="bitflip", which=0):
    """Damage a committed checkpoint in place; returns the path touched.

    ``what``: ``"bitflip"`` flips one bit in the middle of the
    ``which``-th array file (what a checksum must catch);
    ``"truncate"`` halves it (a torn write); ``"manifest"`` truncates the
    manifest; ``"torn_manifest"`` also leaves the whole manifest beside
    it as ``manifest.json.tmp``, as a crash between the manifest's write
    and the directory's fsync can.  A restore treats all of them as a
    corrupt candidate and falls back to the last intact step."""
    from .checkpoint import _MANIFEST, _STEP_FMT, CheckpointManager

    mgr = CheckpointManager(directory, process_count=1)
    step = mgr.latest_step() if step is None else int(step)
    if step is None:
        raise ValueError("no committed checkpoint under %r" % (directory,))
    d = os.path.join(str(directory), _STEP_FMT % step)
    if what in ("manifest", "torn_manifest"):
        path = os.path.join(d, _MANIFEST)
        with open(path, "rb") as f:
            data = f.read()
        if what == "torn_manifest":
            with open(path + ".tmp", "wb") as f:
                f.write(data)
        with open(path, "r+b") as f:
            f.truncate(max(len(data) // 2, 1))
        return path
    names = sorted(n for n in os.listdir(d) if n.endswith(".bin"))
    if not names:
        raise ValueError("no array files in %r" % d)
    path = os.path.join(d, names[int(which) % len(names)])
    if what == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(os.path.getsize(path) // 2, 1))
    elif what == "bitflip":
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            data[len(data) // 2] ^= 0x10
            f.seek(0)
            f.write(data)
    else:
        raise ValueError("what must be 'bitflip', 'truncate', 'manifest' "
                         "or 'torn_manifest', got %r" % (what,))
    return path


def corrupt_compile_cache(directory, what="truncate", which=0):
    """Damage a compile-cache entry (``parallel/aot.py`` ``CompileCache``:
    the built kernel library) in place; returns the path touched.

    ``what``: ``"truncate"`` halves the entry (a torn write);
    ``"bitflip"`` flips one bit mid-file (silent corruption);
    ``"garbage"`` replaces the whole entry with bytes that are no
    library.  Every case must end in a warning and a rebuild: never a
    crash, never a wrong library loaded."""
    names = sorted(n for n in os.listdir(str(directory))
                   if n.endswith(".so") and ".tmp." not in n)
    if not names:
        raise ValueError("no compile-cache entries under %r" % (directory,))
    path = os.path.join(str(directory), names[int(which) % len(names)])
    if what == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(os.path.getsize(path) // 2, 1))
    elif what == "bitflip":
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            data[len(data) // 2] ^= 0x10
            f.seek(0)
            f.write(data)
    elif what == "garbage":
        with open(path, "wb") as f:
            f.write(b"not a cache entry")
    else:
        raise ValueError("what must be 'truncate', 'bitflip' or "
                         "'garbage', got %r" % (what,))
    return path


# ---------------------------------------------------------------------------
# host loss (multi-process training)
# ---------------------------------------------------------------------------

def kill_process():
    """Ungraceful death of this process: SIGKILL to itself, as a
    preempted host dies (no atexit hook, no flush, no signal handler;
    its peers see it only by their own timeouts).  For spawned ranks
    only; it does not return."""
    os.kill(os.getpid(), _signal.SIGKILL)
    time.sleep(60)  # pragma: no cover — the signal wins


@contextmanager
def host_loss_during_save(at=1):
    """Arm :func:`kill_process` on the ``at``-th (0-based) checkpoint
    file write inside the block: the file is written half, then the
    process dies, leaving a torn stage (shard files, or a torn marker)
    that the commit must never publish.  Yields counters (``seen``)."""
    stats = _Stats(seen=0)

    def lethal(real, path, data):
        i = stats.seen
        stats.seen += 1
        if i == at:
            # a lost host interrupts write(2) mid-buffer
            with open(path, "wb") as f:
                f.write(data[:max(len(data) // 2, 1)])
            kill_process()
        return real(path, data)

    with _patched_writer(lethal):
        yield stats


@contextmanager
def coordinator_unreachable(message="connection refused (injected)"):
    """Make the rendezvous fail at once as if the coordinator were gone:
    ``distributed._raw_initialize`` raises ``ConnectionError``, and
    ``distributed.initialize`` must raise ``DistributedInitError`` naming
    the coordinator and the rank."""
    from . import distributed as _dist

    real = _dist._raw_initialize

    def refuse(coordinator, *args, **kwargs):
        raise ConnectionError("%s [coordinator %s]" % (message, coordinator))

    _dist._raw_initialize = refuse
    try:
        yield
    finally:
        _dist._raw_initialize = real


@contextmanager
def straggler_process(delay_s):
    """Delay this process's done-marker by ``delay_s`` seconds during a
    multi-process save: the slow host that process 0's bounded wait must
    absorb (or give up on, without publishing).  Yields counters
    (``delayed``)."""
    stats = _Stats(delayed=0)

    def slow(real, path, data):
        if os.path.basename(path).startswith("done-"):
            stats.delayed += 1
            time.sleep(delay_s)
        return real(path, data)

    with _patched_writer(slow):
        yield stats


# ---------------------------------------------------------------------------
# supervised training (parallel/supervisor.py)
# ---------------------------------------------------------------------------

@contextmanager
def _patched_run_step(flaky):
    """Put ``flaky(real_run, step, x, y)`` in place of
    ``supervisor._run_step``, the one call every supervised step makes."""
    from . import supervisor as _sup

    real = _sup._run_step
    _sup._run_step = lambda step, x, y: flaky(real, step, x, y)
    try:
        yield
    finally:
        _sup._run_step = real


@contextmanager
def hang_step(at=0, duration=3600.0, count=1):
    """Wedge the supervised step call: calls ``at`` to ``at + count - 1``
    (0-based) sleep ``duration`` seconds before the step runs, so the rank
    stops beating mid-step, as a wedged collective or a stuck transfer
    looks from outside.  One long wedge is the hang the supervisor must
    detect, kill and respawn; a short ``duration`` with a large ``count``
    is the per-step slowdown of a straggler.  Yields counters (``seen``,
    ``hung``)."""
    stats = _Stats(seen=0, hung=0)

    def wedge(real, step, x, y):
        i = stats.seen
        stats.seen += 1
        if at <= i < at + count:
            stats.hung += 1
            time.sleep(duration)
        return real(step, x, y)

    with _patched_run_step(wedge):
        yield stats


@contextmanager
def loss_bomb(at=0, factor=1e4):
    """A finite explosion at supervised step call ``at`` (0-based): the
    step's parameters are scaled in place by ``factor``
    (``supervisor._scale_params``) before the call, so the loss explodes
    while every gradient stays finite: ``nonfinite="skip"`` never fires.
    The divergence detector must fire and the rollback to the last
    committed checkpoint must heal the run (the bomb fires once, so the
    replay is clean).  Yields counters (``seen``, ``fired``,
    ``params_scaled``)."""
    from . import supervisor as _sup

    stats = _Stats(seen=0, fired=0, params_scaled=0)

    def bomb(real, step, x, y):
        i = stats.seen
        stats.seen += 1
        if i == at:
            stats.fired += 1
            stats.params_scaled = _sup._scale_params(step, factor)
        return real(step, x, y)

    with _patched_run_step(bomb):
        yield stats


# ---------------------------------------------------------------------------
# the parameter service (parallel/param_service.py)
# ---------------------------------------------------------------------------

@contextmanager
def _patched_transport(push=None, pull=None):
    """Put ``push(real_push, service, rank, updates)`` and/or
    ``pull(real_pull, service, rank, timeout)`` in place of the service's
    transport choke points (``param_service._deliver_push``/
    ``_deliver_pull``)."""
    from . import param_service as _ps

    real_push, real_pull = _ps._deliver_push, _ps._deliver_pull
    if push is not None:
        _ps._deliver_push = \
            lambda svc, rank, updates: push(real_push, svc, rank, updates)
    if pull is not None:
        _ps._deliver_pull = \
            lambda svc, rank, timeout: pull(real_pull, svc, rank, timeout)
    try:
        yield
    finally:
        _ps._deliver_push, _ps._deliver_pull = real_push, real_pull


@contextmanager
def slow_link(rank, delay_s):
    """Add ``delay_s`` seconds to every push and pull of ``rank`` (None:
    every rank), the slow link of a straggler as the service sees it: the
    slowed rank's clock falls behind while its peers push on, and the
    staleness bound is exercised for real.  Yields counters (``pushes``,
    ``pulls``, ``delayed``)."""
    stats = _Stats(pushes=0, pulls=0, delayed=0)

    def spush(real, svc, r, updates):
        stats.pushes += 1
        if rank is None or r == rank:
            stats.delayed += 1
            time.sleep(delay_s)
        return real(svc, r, updates)

    def spull(real, svc, r, timeout):
        stats.pulls += 1
        if rank is None or r == rank:
            stats.delayed += 1
            time.sleep(delay_s)
        return real(svc, r, timeout)

    with _patched_transport(push=spush, pull=spull):
        yield stats


@contextmanager
def drop_push(p, seed=0):
    """Lose a fraction ``p`` of the push payloads, drawn from ``seed``: a
    lost push still commits its step (fire and forget: the clock
    advances, so no peer deadlocks on a lossy link) but its gradient
    never reaches the server.  With error-feedback compression the next
    push carries what the residual banked.  Yields counters (``seen``,
    ``dropped``)."""
    if not 0.0 <= float(p) <= 1.0:
        raise ValueError("drop probability must be in [0, 1], got %r"
                         % (p,))
    rng = np.random.default_rng(int(seed))
    stats = _Stats(seen=0, dropped=0)

    def drop(real, svc, r, updates):
        stats.seen += 1
        if rng.random() < float(p):
            stats.dropped += 1
            return real(svc, r, {})  # the payload is lost, the step commits
        return real(svc, r, updates)

    with _patched_transport(push=drop):
        yield stats


# ---------------------------------------------------------------------------
# serving (serve/batcher.py, serve/engine.py)
# ---------------------------------------------------------------------------

class _BadPayload:
    """An object whose array conversion raises: a request body that is
    not even parseable."""

    def __array__(self, *a, **k):
        raise ValueError("injected unconvertible request payload")


def malformed_request(sample_shape, kind="rank"):
    """A request payload the batcher must reject on its own future, never
    killing the batch it rode in, the worker or the queue.

    ``kind``: ``"rank"`` (an extra dimension), ``"shape"`` (right rank,
    wrong extents), ``"dtype"`` (an object payload that cannot cast to
    the sample dtype) or ``"unconvertible"`` (``np.asarray`` raises)."""
    shape = tuple(int(s) for s in sample_shape)
    if kind == "rank":
        return np.zeros((2,) + shape, np.float32)
    if kind == "shape":
        return np.zeros(tuple(s + 1 for s in shape) or (3,), np.float32)
    if kind == "dtype":
        return np.full(shape, "poison", dtype=object)
    if kind == "unconvertible":
        return _BadPayload()
    raise ValueError("kind must be 'rank', 'shape', 'dtype' or "
                     "'unconvertible', got %r" % (kind,))


@contextmanager
def slow_client(delay_s, at=0, count=None):
    """Stall request admission by ``delay_s`` seconds from the ``at``-th
    submit on (``count`` bounds how many; ``None``: all), the trickling
    client whose requests only the deadline flush can bound.  Interposes
    ``serve/batcher.py::_admit``.  Yields counters (``seen``,
    ``slowed``)."""
    from ..serve import batcher as _batcher

    stats = _Stats(seen=0, slowed=0)
    real = _batcher._admit

    def slow(req):
        i = stats.seen
        stats.seen += 1
        if i >= at and (count is None or stats.slowed < count):
            stats.slowed += 1
            time.sleep(delay_s)
        return real(req)

    _batcher._admit = slow
    try:
        yield stats
    finally:
        _batcher._admit = real


@contextmanager
def _patched_serve(flaky):
    """Put ``flaky(real_serve, engine, xv)`` in place of
    ``serve/batcher.py::_serve_batch`` inside the block."""
    from ..serve import batcher as _batcher

    real = _batcher._serve_batch
    _batcher._serve_batch = lambda engine, xv: flaky(real, engine, xv)
    try:
        yield
    finally:
        _batcher._serve_batch = real


@contextmanager
def kill_batcher_worker(at=0, count=1):
    """Kill the batcher's worker thread silently on the ``at``-th to
    ``at+count-1``-th batch executions: ``SystemExit`` escapes the
    worker loop, as a thread's abort does.  The watchdog must fail the
    lost batch and respawn the worker.  Yields counters (``seen``,
    ``killed``)."""
    stats = _Stats(seen=0, killed=0)

    def kill(real, engine, xv):
        i = stats.seen
        stats.seen += 1
        if at <= i < at + count:
            stats.killed += 1
            raise SystemExit("injected batcher worker death (#%d)" % i)
        return real(engine, xv)

    with _patched_serve(kill):
        yield stats


@contextmanager
def engine_failure_burst(n=3, exc=None, engine=None):
    """Make the next ``n`` engine executions raise a transient
    ``RuntimeError`` (or ``exc``): retry absorbs a short burst, a long
    one must trip the circuit breaker.  ``engine`` limits the fault to
    that engine (a fallback tier stays healthy).  Yields counters
    (``seen``, ``failed``)."""
    stats = _Stats(seen=0, failed=0)

    def burst(real, eng, xv):
        i = stats.seen
        stats.seen += 1
        if stats.failed < n and (engine is None or eng is engine):
            stats.failed += 1
            raise exc or RuntimeError(
                "injected engine failure burst (#%d)" % i)
        return real(eng, xv)

    with _patched_serve(burst):
        yield stats


def nan_params(engine, value=float("nan"), index=0):
    """A poisoned hot-swap candidate: the engine's net parameters (the
    pinned signature's values) copied to the host, with ``value`` (NaN)
    at flat position ``index`` of the first floating one.  The canary
    must reject it and the old version keep serving.  Returns a list in
    the engine's parameter order."""
    if not getattr(engine, "_params", None):
        raise ValueError("engine has no collected params -- warmup() it "
                         "first (the swap path requires it anyway)")
    raw = [p._tensor.detach().cpu().numpy().copy() for p in engine._params]
    for a in raw:
        if np.issubdtype(a.dtype, np.floating):
            a.reshape(-1)[index] = value
            break
    else:
        raise ValueError("engine has no floating parameter to poison")
    return raw


def deadline_storm(batcher, payloads, deadline=1e-4, priority=0):
    """Submit every payload back to back with an SLO deadline so tight it
    expires in the queue: the batcher must shed them before compute and
    never hang.  Returns ``(futures, shed_count)``."""
    from ..serve.batcher import Backpressure

    futures, shed = [], 0
    for p in payloads:
        try:
            futures.append(batcher.submit(p, block=False,
                                          deadline=deadline,
                                          priority=priority))
        except Backpressure:
            shed += 1
    return futures, shed


def burst_arrivals(batcher, payloads, block=False):
    """Submit every payload back to back, unpaced: the herd a bounded
    queue must absorb or shed as ``Backpressure``.  Returns
    ``(futures, shed_count)``."""
    from ..serve.batcher import Backpressure

    futures, shed = [], 0
    for p in payloads:
        try:
            futures.append(batcher.submit(p, block=block))
        except Backpressure:
            shed += 1
    return futures, shed


def _live_param_snapshot(engine):
    """``(version, [host copies])`` of the engine's live slot, a quantized
    parameter's codes and amax as two leaves: the bitwise oracle for a
    rejected swap."""
    ver, vals = engine._live
    return ver, [t.detach().cpu().clone() for v in vals
                 for t in (v if isinstance(v, tuple) else (v,))]


def _leaves_equal(a, b) -> bool:
    """Bit for bit (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


@contextmanager
def swap_storm(engine, n_swaps=5, interval=0.02, perturb=0.02,
               canary_tol=0.5, poison_at=None, seed=0):
    """``n_swaps`` canaried hot swaps ``interval`` seconds apart (the
    first ``interval`` after entry) from a thread while the caller serves
    traffic inside the block.

    Each candidate is the live version at storm start, in the pinned
    signature's dtypes, scaled by ``1 + perturb * U(-1, 1)`` (one draw a
    candidate), so it passes the canary drift gate (``canary_tol``) and
    commits; ``poison_at=k`` makes the ``k``-th candidate
    :func:`nan_params`: it must be rejected with the incumbent bitwise
    unchanged.  Yields counters: ``attempted``, ``committed``,
    ``rejected``, ``versions``, ``poison_rejected`` and
    ``incumbent_bitwise_ok`` (``None`` without ``poison_at``), and
    ``error`` (a crash of the storm thread).  The thread is joined on
    exit."""
    import threading

    from ..serve.resilience import SwapRejected

    if not getattr(engine, "_params", None):
        raise ValueError("warmup() the engine first -- the storm replays "
                         "the canaried swap path")
    from ..ops.quantization import dequantize_tensor

    sig = engine.param_signature
    base = []
    for i, v in enumerate(engine._live[1]):
        # an int8 tier's candidate is its live codes dequantized
        t = (dequantize_tensor(*v) if isinstance(v, tuple) else v) \
            .detach().cpu()
        base.append(np.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                               else t.numpy(), sig[i][2]))
    rng = np.random.RandomState(seed)
    stats = _Stats(attempted=0, committed=0, rejected=0, versions=[],
                   poison_rejected=None, incumbent_bitwise_ok=None,
                   error=None)

    def one_candidate():
        out = []
        for a in base:
            if np.issubdtype(a.dtype, np.floating):
                out.append(np.asarray(
                    a * (1.0 + perturb * rng.uniform(-1.0, 1.0)), a.dtype))
            else:
                out.append(np.array(a))
        return out

    def storm():
        try:
            for i in range(n_swaps):
                # ``interval`` before each swap, the first too: the
                # caller's traffic has begun when the first lands (a
                # swap of a small net takes ~1 ms, less than the caller
                # takes to open its window; ROADMAP C9)
                time.sleep(interval)
                stats.attempted += 1
                if poison_at is not None and i == poison_at:
                    before = _live_param_snapshot(engine)
                    try:
                        engine.update_params(nan_params(engine),
                                             canary_tol=canary_tol,
                                             context="swap_storm")
                        stats.poison_rejected = False
                    except SwapRejected:
                        stats.poison_rejected = True
                    after = _live_param_snapshot(engine)
                    stats.incumbent_bitwise_ok = (
                        before[0] == after[0]
                        and len(before[1]) == len(after[1])
                        and all(_leaves_equal(x, y)
                                for x, y in zip(before[1], after[1])))
                else:
                    try:
                        v = engine.update_params(one_candidate(),
                                                 canary_tol=canary_tol,
                                                 context="swap_storm")
                        stats.committed += 1
                        stats.versions.append(int(v))
                    except SwapRejected:
                        stats.rejected += 1
        except BaseException as e:  # surface, never die silently
            stats.error = "%s: %s" % (type(e).__name__, e)

    t = threading.Thread(target=storm, name="swap-storm", daemon=True)
    t.start()
    try:
        yield stats
    finally:
        t.join(timeout=120.0)
        if t.is_alive():
            stats.error = stats.error or \
                "swap storm thread failed to finish"
