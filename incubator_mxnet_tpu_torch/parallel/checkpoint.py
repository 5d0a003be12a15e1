"""Atomic checkpoints of training state (port of
``incubator_mxnet_tpu/parallel/checkpoint.py``).

- **manifest** — per leaf its tree key, dtype, shape, files and
  checksums, so restore verifies every file before touching live state;
- **per-shard files** — a leaf sharded over the processes (a ZeRO-1
  optimizer-state leaf, :class:`Shard`) is written one file per rank's
  rows, by that rank: nothing is gathered;
- **atomic commit** — every file is written into a ``.tmp-step-*``
  staging directory, fsync'd, and published with ONE ``os.replace``; a
  crash mid-save leaves the previous checkpoint untouched;
- **last-good fallback** — restore walks back to the newest intact
  checkpoint when the latest fails validation;
- **bounded retry** — transient ``OSError`` s on reads and writes retry
  with jittered exponential backoff;
- **preemption hook** — SIGTERM flips a flag; an attached train step
  saves at its next boundary (``TrainStep.attach_checkpoint``).

The on-disk format is the JAX package's byte for byte: the same
``step-%08d`` directories, ``manifest.json`` (``format_version``, per
leaf ``key``/``dtype``/``shape``/``spec``/``files``, ``crc32c:`` or
``crc32:`` checksums, ``meta``), ``done-p%05d.json`` markers and raw
little-endian payloads, so a checkpoint written by either package
restores in the other, and the two packages' managers can take part in
one multi-process commit.  A state is a tree of dicts, lists and tuples
whose leaves are ``torch.Tensor`` s, numpy arrays or :class:`Shard` s;
it is flattened as ``jax.tree_util`` flattens it (dict keys sorted,
sequences by index, ``None`` no leaf) and keyed with the strings
``jax.tree_util.keystr`` gives (``['opt_state'][3][1]``).  bfloat16
leaves travel as their 16-bit patterns.

**Multi-process checkpoints.**  With ``process_count > 1`` (by default
the ``torch.distributed`` group's size) every process calls ``save`` and
``restore`` on the same shared directory, and the reference's commit
protocol runs over the filesystem alone (no collective, so a lost peer
times out instead of hanging the others):

1. every process stages only what it owns into the shared
   ``.tmp-step-N/``: its own :class:`Shard` s, and on process 0 the
   replicated leaves;
2. each then writes a ``done-pNNNNN.json`` marker with its file list,
   checksums, its ``meta`` (the data iterator's state) and the launch
   attempt (``MXNET_RESTART_COUNT``), and fsyncs;
3. process 0 waits for every marker of this attempt (``commit_timeout``),
   checks that every leaf's shards are complete, merges the processes'
   iterator states under ``meta["data_iter_parts"]``, writes the one
   ``manifest.json`` last and commits with the same rename, so a stage
   torn by a lost host is never visible;
4. the others wait for that commit (``commit_timeout``): ``save``
   returning means the checkpoint is durable for every process.

Process 0 alone sweeps debris and retires old steps, and leaves alone
any directory a peer wrote to within ``stale_grace`` seconds.

**Elastic restore.**  ``restore(like, elastic=...)`` re-slices a leaf
marked with its logical leading dim (ZeRO-1 state padded to a multiple
of the saved dp width) to the logical rows and re-pads it to this run's
width; a :class:`Shard` in ``like`` reads back only the files that hold
its rows.  Any other shape change raises
:class:`CheckpointTopologyError` naming both topologies.  Since a
process reads only its own rows, only the reader of a corrupt file sees
it: in a ``torch.distributed`` group the processes of a restore agree
on the step (one small ``all_reduce`` a candidate), so every process
of the group calls ``restore`` and all load the same step or all raise.

The reference's GL009 warning (a process-local directory given to a
multi-process manager) comes from its ``analysis/trace_lint``, which the
port has not yet (ROADMAP A12).
"""
from __future__ import annotations

import json
import os
import random
import shutil
import signal
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import dtype_name, np_dtype

__all__ = ["CheckpointError", "CheckpointCorruptError",
           "CheckpointTopologyError", "CheckpointManager", "Shard",
           "checkpoint_requested", "install_preemption_hook",
           "request_checkpoint", "request_seq",
           "uninstall_preemption_hook"]

_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_STEP_FMT = "step-%08d"
_TMP_PREFIX = ".tmp-"
_DISCARD_PREFIX = ".discard-"
_DONE_FMT = "done-p%05d.json"


class CheckpointError(RuntimeError):
    """No usable checkpoint (nothing saved yet, or every candidate is
    corrupt)."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint failed integrity validation: missing file,
    unparseable or mismatched manifest, or checksum mismatch."""


class CheckpointTopologyError(CheckpointError):
    """The checkpoint is intact but was saved under a training topology
    this run cannot re-shard onto.  Not a corruption: restore refuses at
    once, naming both topologies, instead of walking back."""


class Shard:
    """One process's block of a leaf sharded over the processes on its
    leading dim: ``data`` (a tensor or an array) holds rows ``rows =
    (lo, hi)`` of a global array of ``shape``; it is block ``ordinal`` of
    ``count``, and process ``ordinal`` owns it, or process ``owner``
    where the block has copies on several processes (a tensor- or
    expert-parallel block on each data-parallel replica): the owner
    writes it and the others write nothing.  ``spec`` is the manifest's
    description of the sharding.  In a state given to
    :meth:`CheckpointManager.save` it is written as that block's file; in
    the ``like`` tree of a restore it asks for just those rows."""

    def __init__(self, data, shape, rows, ordinal, count, spec=None,
                 owner=None):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.rows = (int(rows[0]), int(rows[1]))
        self.ordinal = int(ordinal)
        self.count = int(count)
        self.spec = spec
        self.owner = None if owner is None else int(owner)

    @property
    def dtype(self):
        return self.data.dtype

    def index_json(self):
        """The block's index as the manifest records it (the reference's
        ``[[start, stop], ...]``, ``None`` for a whole dim)."""
        return [list(self.rows)] + [[None, None]] * (len(self.shape) - 1)

    def __repr__(self):
        return "Shard(%d of %d, rows %s of %s)" % (
            self.ordinal, self.count, self.rows, self.shape)


# ---------------------------------------------------------------------------
# the state tree, flattened as jax.tree_util flattens it
# ---------------------------------------------------------------------------

def _flatten(tree, none_is_leaf=False, prefix=""):
    """``[(key, leaf)]``: dict keys sorted, lists and tuples by index,
    ``None`` no leaf (a leaf with ``none_is_leaf``), each key the string
    ``jax.tree_util.keystr`` gives its path."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], none_is_leaf, prefix + "[%r]" % (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, none_is_leaf, prefix + "[%d]" % i)
        return out
    if tree is None and not none_is_leaf:
        return []
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _leaf_header(leaf) -> Tuple[str, List[int]]:
    """``(dtype name, shape)`` of a tensor or an array (a :class:`Shard`:
    of its block), copying nothing."""
    if isinstance(leaf, Shard):
        leaf = leaf.data
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype), list(leaf.shape)
    a = np.asarray(leaf)
    return a.dtype.name, list(a.shape)


def _leaf_bytes(leaf) -> Tuple[str, List[int], bytes]:
    """``(dtype name, shape, raw little-endian bytes)`` of a tensor (any
    device) or an array (a :class:`Shard`: of its block)."""
    if isinstance(leaf, Shard):
        leaf = leaf.data
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(t.shape), t.numpy().tobytes()
    a = np.asarray(leaf)
    return a.dtype.name, list(a.shape), a.tobytes()  # C order


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a payload is read as: bfloat16 as its 16-bit
    patterns, so no reader needs ``ml_dtypes``."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _place(arr: np.ndarray, name: str, like):
    """A restored payload as ``like``'s kind of leaf: a tensor on
    ``like``'s device, or a numpy array, in the saved dtype (a
    :class:`Shard`: as its ``data``)."""
    if isinstance(like, Shard):
        like = like.data
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(like.device)
    return arr.view(np_dtype(name)) if name == "bfloat16" else arr


# ---------------------------------------------------------------------------
# integrity and I/O primitives
# ---------------------------------------------------------------------------

def _checksum(data) -> str:
    """``"algo:hex"`` over the payload: crc32c when the optional
    ``crc32c`` module is present, else zlib's crc32; the algorithm rides
    the manifest."""
    try:
        import crc32c  # type: ignore

        return "crc32c:%08x" % (crc32c.crc32c(data) & 0xFFFFFFFF)
    except ImportError:
        return "crc32:%08x" % (zlib.crc32(data) & 0xFFFFFFFF)


def _verify_checksum(data, recorded: str,
                     fallback_crc32: Optional[str] = None) -> bool:
    """Verify against the recorded checksum; where its algorithm is not
    installed here, against the plain crc32 every manifest also records."""
    algo, _, hexval = recorded.partition(":")
    if algo == "crc32":
        return ("%08x" % (zlib.crc32(data) & 0xFFFFFFFF)) == hexval
    if algo == "crc32c":
        try:
            import crc32c  # type: ignore
        except ImportError:
            if fallback_crc32 is not None:
                return ("%08x" % (zlib.crc32(data) & 0xFFFFFFFF)) \
                    == fallback_crc32
            return False  # nothing verifiable -> fail safe
        return ("%08x" % (crc32c.crc32c(data) & 0xFFFFFFFF)) == hexval
    return False


def _write_bytes(path: str, data) -> None:
    """Write, flush and fsync one file.  Module-level, so the fault
    harness (``parallel/fault_injection.py``) can put failures, delays
    and a process's death in its place."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _read_bytes(path: str) -> bytearray:
    """The whole file, in a writable buffer (tensors are made on it
    without another copy)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        n = f.readinto(buf)
    return buf[:n] if n < len(buf) else buf


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _with_retries(fn, retries: int, backoff: float):
    """Run ``fn`` retrying transient ``OSError`` s with exponential
    backoff, jittered 0.5-1.5x so processes hitting one filesystem do not
    retry in step; the last failure propagates."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError:
            if attempt == retries:
                raise
            time.sleep(backoff * (2 ** attempt) * (0.5 + random.random()))


def _index_from_json(spec) -> Tuple[slice, ...]:
    return tuple(slice(lo, hi) for (lo, hi) in spec)


def _topology_mismatch(saved: Dict, current: Dict) -> Optional[str]:
    """What, beyond an elastic change (the batch axis's width, the
    process count, the ZeRO mode), differs between two topology stamps
    (``TrainStep._topology()``)."""
    for key in ("batch_axis", "pipeline_stages"):
        if saved.get(key) != current.get(key):
            return "%s %r != %r" % (key, saved.get(key), current.get(key))
    sm, cm = saved.get("mesh"), current.get("mesh")
    if (sm is None) != (cm is None):
        return "mesh %r != %r" % (sm, cm)
    if sm:
        if set(sm) != set(cm):
            return "mesh axes %s != %s" % (sorted(sm), sorted(cm))
        ba = current.get("batch_axis")
        for a in sorted(sm):
            if a != ba and sm[a] != cm[a]:
                return ("mesh axis %r width %s != %s (only the %r batch "
                        "axis re-shards elastically)" % (a, sm[a], cm[a],
                                                         ba))
    return None


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Atomic checkpoints of a tree of tensors under one directory,
    newest-intact-wins restore.

    ``save(step, state)`` writes every leaf, the manifest last, fsyncs
    and commits with one atomic rename, then retires checkpoints beyond
    ``keep_last``.  ``restore(like)`` validates checksums and manifest
    and falls back to the next older checkpoint on corruption.
    ``retries``/``backoff`` bound the retries around every file read and
    write.

    ``process_index``/``process_count`` default to the
    ``torch.distributed`` group's (0 and 1 without one).  With more than
    one process every process calls ``save``/``restore`` on the same
    shared directory and the module docstring's commit protocol runs;
    ``commit_timeout`` bounds each process's wait for its peers at the
    commit, and ``stale_grace`` is how long ago a staging directory or a
    retired step must have been written before process 0 deletes it (a
    peer's fresh files are never deleted; one process sweeps debris at
    once, as a single writer)."""

    def __init__(self, directory: str, keep_last: int = 3, retries: int = 2,
                 backoff: float = 0.05, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 commit_timeout: float = 120.0, stale_grace: float = 300.0):
        from . import distributed as _dist

        self.directory = str(directory)
        if keep_last is not None and int(keep_last) < 1:
            raise ValueError("keep_last must be >= 1 or None, got %r"
                             % (keep_last,))
        self.keep_last = None if keep_last is None else int(keep_last)
        self.retries = int(retries)
        self.backoff = float(backoff)
        if process_count is None:
            process_count = _dist.process_count()
        if process_index is None:
            process_index = _dist.process_index() \
                if int(process_count) > 1 else 0
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if not 0 <= self.process_index < max(self.process_count, 1):
            raise ValueError("process_index %d outside process_count %d"
                             % (self.process_index, self.process_count))
        self.commit_timeout = float(commit_timeout)
        self.stale_grace = float(stale_grace)

    # -- layout ---------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, _STEP_FMT % step)

    def steps(self) -> List[int]:
        """Committed step numbers, ascending."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step-"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _manifest_committed(self, step: int) -> bool:
        """True iff ``step``'s manifest exists, parses and carries the
        format version: it is written last, so it tells a committed
        directory from a torn one."""
        try:
            with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        return manifest.get("format_version") == _FORMAT_VERSION

    def latest_committed(self) -> Optional[int]:
        """Newest step whose manifest parses and matches the format
        version: what a polling consumer may act on.  Staging and discard
        directories never match the step prefix."""
        for s in reversed(self.steps()):
            if self._manifest_committed(s):
                return s
        return None

    def watch(self, after: Optional[int] = None, timeout: float = 10.0,
              poll: float = 0.05) -> Optional[int]:
        """Block until a committed step newer than ``after`` appears and
        return it, or ``None`` once ``timeout`` seconds have passed.  Only
        committed manifests are ever returned: never a stage being
        committed, nor a torn directory."""
        deadline = time.monotonic() + float(timeout)
        while True:
            s = self.latest_committed()
            if s is not None and (after is None or s > int(after)):
                return s
            if time.monotonic() >= deadline:
                return None
            time.sleep(poll)

    # -- save -----------------------------------------------------------
    def save(self, step: int, state, meta: Optional[Dict] = None) -> str:
        """Stage and atomically commit ``state`` as checkpoint ``step``;
        returns the committed directory.  ``meta`` — an optional
        JSON-safe dict (the data iterator's position, the topology)
        committed with the arrays in the manifest.  With several
        processes every process calls it (module docstring)."""
        step = int(step)
        flat = _flatten(state)
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, _TMP_PREFIX + (_STEP_FMT % step))
        final = self._step_dir(step)
        if self.process_count > 1:
            return self._save_multiprocess(step, flat, meta, tmp, final)
        # one writer: any staging debris, a crashed earlier attempt at
        # this step included, is an orphan
        self._sweep_stale()
        os.makedirs(tmp)
        try:
            entries = [self._save_leaf(tmp, "arr_%05d" % i, key, leaf)
                       for i, (key, leaf) in enumerate(flat)]
            manifest = {"format_version": _FORMAT_VERSION, "step": step,
                        "arrays": entries}
            if meta is not None:
                manifest["meta"] = meta
            self._write_manifest_and_commit(tmp, final, manifest)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retire()
        return final

    def _write_manifest_and_commit(self, tmp: str, final: str,
                                   manifest: Dict) -> None:
        """Write ``manifest.json`` last, fsync the staging directory and
        publish it with one atomic rename; a re-saved step's old
        directory moves aside first and comes back if the rename fails."""
        buf = json.dumps(manifest, indent=1).encode()
        _with_retries(
            lambda: _write_bytes(os.path.join(tmp, _MANIFEST), buf),
            self.retries, self.backoff)
        _fsync_dir(tmp)
        discard = None
        committed = False
        try:
            if os.path.isdir(final):
                discard = os.path.join(
                    os.path.dirname(final),
                    _DISCARD_PREFIX + os.path.basename(final))
                shutil.rmtree(discard, ignore_errors=True)
                os.replace(final, discard)
            os.replace(tmp, final)  # THE commit point
            committed = True
        finally:
            if discard is not None and os.path.isdir(discard):
                if committed:
                    shutil.rmtree(discard, ignore_errors=True)
                elif not os.path.isdir(final):
                    os.replace(discard, final)
        _fsync_dir(self.directory)

    # -- the multi-process commit ---------------------------------------
    def _save_multiprocess(self, step: int, flat, meta, tmp: str,
                           final: str) -> str:
        """This process stages what it owns and its done-marker; process
        0 checks every marker and publishes the one manifest."""
        # a re-save of a committed step: the old commit must not satisfy
        # the others' wait, so remember what it looked like
        pre_stat = self._manifest_stat(final)
        if self.process_index == 0:
            self._sweep_stale(keep=os.path.basename(tmp))
            # markers of a crashed earlier attempt at this step, older
            # than stale_grace, go; a peer's fresh one stays
            if os.path.isdir(tmp):
                now = time.time()
                for name in os.listdir(tmp):
                    if not name.startswith("done-"):
                        continue
                    path = os.path.join(tmp, name)
                    try:
                        if now - os.path.getmtime(path) > self.stale_grace:
                            os.unlink(path)
                    except OSError:
                        continue
        os.makedirs(tmp, exist_ok=True)
        # no rmtree on failure: peers may still be writing into the
        # shared stage, which stays invisible and ages out
        skeletons = []
        mine: Dict[str, List] = {}
        for i, (key, leaf) in enumerate(flat):
            name = "arr_%05d" % i
            entry, owned, expected = self._save_leaf_owned(tmp, name, key,
                                                           leaf)
            skeletons.append((entry, expected))
            if owned:
                mine[name] = owned
        marker = {"format_version": _FORMAT_VERSION, "step": step,
                  "process": self.process_index, "files": mine,
                  # the launcher's attempt (tools/launch_torch.py
                  # --max-restarts): a crashed earlier attempt's marker is
                  # refused even inside stale_grace
                  "attempt": os.environ.get("MXNET_RESTART_COUNT"),
                  "meta": meta}
        # the stage's entries are durable before the marker is visible:
        # once it is, process 0 may commit (rename the stage) at any
        # moment, so this process touches the stage no more; process 0's
        # fsync of the stage before its commit covers the marker's entry
        _fsync_dir(tmp)
        _with_retries(
            lambda: _write_bytes(
                os.path.join(tmp, _DONE_FMT % self.process_index),
                json.dumps(marker).encode()),
            self.retries, self.backoff)
        if self.process_index != 0:
            self._wait_commit(step, final, pre_stat)
            return final
        markers = self._wait_markers(tmp, step)
        arrays = []
        for i, (entry, expected) in enumerate(skeletons):
            name = "arr_%05d" % i
            collected: List = []
            for r in sorted(markers):
                collected.extend(markers[r]["files"].get(name, []))
            collected.sort(key=lambda kf: kf[0])
            if [k for k, _ in collected] != list(range(expected)):
                raise CheckpointError(
                    "multi-process checkpoint step %d: array %s has "
                    "shard files %s from the %d done-markers, expected "
                    "exactly shards 0..%d — a process staged an "
                    "inconsistent state tree; NOT committing"
                    % (step, name, [k for k, _ in collected],
                       len(markers), expected - 1))
            entry["files"] = [f for _, f in collected]
            arrays.append(entry)
        manifest = {"format_version": _FORMAT_VERSION, "step": step,
                    "arrays": arrays}
        merged_meta = self._merge_meta(markers)
        if merged_meta is not None:
            manifest["meta"] = merged_meta
        self._write_manifest_and_commit(tmp, final, manifest)
        self._retire()
        return final

    @staticmethod
    def _merge_meta(markers: Dict[int, Dict]) -> Optional[Dict]:
        """Process 0's meta, with every process's ``data_iter`` state
        collected under ``data_iter_parts`` (keyed by rank as a string),
        so a restore can re-split the stream over another process
        count."""
        base = markers[0].get("meta")
        merged = dict(base) if base else {}
        parts = {str(r): m["meta"]["data_iter"] for r, m in markers.items()
                 if m.get("meta") and m["meta"].get("data_iter") is not None}
        if parts:
            merged["data_iter_parts"] = parts
        return merged or None

    def _wait_markers(self, tmp: str, step: int) -> Dict[int, Dict]:
        """Process 0: every process's marker of this step and attempt, or
        :class:`CheckpointError` after ``commit_timeout`` seconds.  A torn
        marker (its writer died mid-write) never parses, so a torn stage
        is never committed."""
        deadline = time.monotonic() + self.commit_timeout
        need = set(range(self.process_count))
        attempt = os.environ.get("MXNET_RESTART_COUNT")
        got: Dict[int, Dict] = {}
        while True:
            for r in sorted(need - set(got)):
                path = os.path.join(tmp, _DONE_FMT % r)
                if not os.path.exists(path):
                    continue
                try:
                    m = json.loads(_read_bytes(path).decode())
                except (OSError, ValueError):
                    continue  # torn or in flight: keep waiting
                if m.get("step") == step and m.get("process") == r \
                        and m.get("attempt") == attempt:
                    got[r] = m
            if len(got) == len(need):
                return got
            if time.monotonic() > deadline:
                raise CheckpointError(
                    "multi-process checkpoint step %d: process 0 timed "
                    "out after %.0fs waiting for done-marker(s) from "
                    "process(es) %s under %s — a host was likely lost "
                    "mid-save; the half-written stage was NOT committed "
                    "and the last committed checkpoint is untouched"
                    % (step, self.commit_timeout,
                       sorted(need - set(got)), tmp))
            time.sleep(0.05)

    @staticmethod
    def _manifest_stat(final: str) -> Optional[Tuple[int, int]]:
        """``(st_ino, st_mtime_ns)`` of a committed manifest, None when
        the step is not committed: a re-saved step's new commit has a new
        inode."""
        try:
            st = os.stat(os.path.join(final, _MANIFEST))
            return (st.st_ino, st.st_mtime_ns)
        except OSError:
            return None

    def _wait_commit(self, step: int, final: str,
                     pre_stat: Optional[Tuple[int, int]] = None) -> None:
        """Processes other than 0: wait until process 0 publishes a
        manifest other than ``pre_stat`` (the commit seen before this
        save), so ``save`` returning means this checkpoint is durable.
        ``commit_timeout=0`` returns at once (staging only: how one
        process drives one rank of the protocol in a test)."""
        if self.commit_timeout == 0:
            return
        deadline = time.monotonic() + self.commit_timeout
        while self._manifest_stat(final) in (None, pre_stat):
            if time.monotonic() > deadline:
                raise CheckpointError(
                    "multi-process checkpoint step %d: process %d timed "
                    "out after %.0fs waiting for process 0 to commit %s "
                    "— the coordinator was likely lost mid-save; the "
                    "last committed checkpoint is untouched"
                    % (step, self.process_index, self.commit_timeout,
                       final))
            time.sleep(0.05)

    @staticmethod
    def _newest_mtime(path: str) -> float:
        """Newest mtime of ``path`` and of what lies directly in it."""
        try:
            newest = os.path.getmtime(path)
            for name in os.listdir(path):
                try:
                    newest = max(newest, os.path.getmtime(
                        os.path.join(path, name)))
                except OSError:
                    continue
            return newest
        except OSError:
            return 0.0

    def _sweep_stale(self, keep: Optional[str] = None):
        """Remove staging and discard debris of crashed earlier saves.
        One process owns the directory, so all of it is orphaned; with
        several, process 0 sweeps all but ``keep`` (this save's stage) and
        what was written within ``stale_grace`` seconds."""
        for name in os.listdir(self.directory):
            if not (name.startswith(_TMP_PREFIX)
                    or name.startswith(_DISCARD_PREFIX)) or name == keep:
                continue
            path = os.path.join(self.directory, name)
            if self.process_count > 1 and \
                    time.time() - self._newest_mtime(path) < self.stale_grace:
                continue
            shutil.rmtree(path, ignore_errors=True)

    def _save_leaf(self, tmp: str, name: str, key: str, leaf) -> Dict:
        if isinstance(leaf, Shard) and leaf.count > 1:
            raise CheckpointError(
                "leaf %s is block %d of %d of a leaf sharded over %d "
                "processes; a one-process manager cannot write the other "
                "blocks: give every process a manager with process_count="
                "%d" % (key, leaf.ordinal, leaf.count, leaf.count,
                        leaf.count))
        dtype, shape, data = _leaf_bytes(leaf)
        entry = {"key": key, "dtype": dtype, "shape": shape, "spec": None,
                 "files": []}
        entry["files"].append(self._write_payload(
            tmp, name + ".bin", data, index=None, part_shape=shape))
        return entry

    def _save_leaf_owned(self, tmp: str, name: str, key: str,
                         leaf) -> Tuple[Dict, List, int]:
        """Stage only what this process owns: its :class:`Shard`, or on
        process 0 a replicated leaf (identical everywhere), one file.
        Returns ``(manifest entry without files, [[block, file entry]]
        written here, number of blocks)``."""
        dtype, part_shape = _leaf_header(leaf)
        if not isinstance(leaf, Shard):
            entry = {"key": key, "dtype": dtype, "shape": part_shape,
                     "spec": None, "files": []}
            if self.process_index != 0:
                return entry, [], 1
            return entry, [[0, self._write_payload(
                tmp, name + ".bin", _leaf_bytes(leaf)[2], index=None,
                part_shape=part_shape)]], 1
        entry = {"key": key, "dtype": dtype, "shape": list(leaf.shape),
                 "spec": leaf.spec, "files": []}
        if leaf.owner is not None:
            if leaf.owner != self.process_index:
                return entry, [], leaf.count
        elif leaf.ordinal != self.process_index:
            raise CheckpointError(
                "process %d holds block %d of %s: each process saves the "
                "block it owns" % (self.process_index, leaf.ordinal, key))
        data = _leaf_bytes(leaf)[2]
        payload = self._write_payload(
            tmp, "%s.shard%03d.bin" % (name, leaf.ordinal), data,
            index=leaf.index_json(), part_shape=part_shape)
        return entry, [[leaf.ordinal, payload]], leaf.count

    def _write_payload(self, tmp, fname, data, index, part_shape) -> Dict:
        _with_retries(
            lambda: _write_bytes(os.path.join(tmp, fname), data),
            self.retries, self.backoff)
        return {"file": fname, "checksum": _checksum(data),
                # always-verifiable fallback digest (see _verify_checksum)
                "crc32": "%08x" % (zlib.crc32(data) & 0xFFFFFFFF),
                "nbytes": len(data), "index": index,
                "part_shape": part_shape}

    def _retire(self):
        """Delete the committed steps beyond ``keep_last``; with several
        processes only process 0 does, and not a step written within
        ``stale_grace`` seconds (a peer may still be reading it)."""
        if self.keep_last is None:
            return
        if self.process_count > 1 and self.process_index != 0:
            return
        for s in self.steps()[:-self.keep_last]:
            d = self._step_dir(s)
            if self.process_count > 1 and \
                    time.time() - self._newest_mtime(d) < self.stale_grace:
                continue
            shutil.rmtree(d, ignore_errors=True)

    # -- restore --------------------------------------------------------
    def restore(self, like, step: Optional[int] = None,
                return_meta: bool = False, elastic=None, topology=None):
        """Load the newest intact checkpoint (or exactly ``step``) into
        the structure of ``like``; returns ``(step, state)``, or ``(step,
        state, meta)`` with ``return_meta=True``.  Each restored leaf is
        of ``like``'s kind (a tensor on its device, or a numpy array; for
        a :class:`Shard`, its rows as its ``data``'s kind) in the saved
        dtype.  Corrupt candidates are skipped with a warning unless
        ``step`` pinned one.

        ``elastic`` — an optional tree congruent with ``like`` whose
        leaves are ``None`` (exact shape required) or an ``int``: the
        logical leading dim of a leaf whose stored leading dim is padded
        (ZeRO-1 optimizer state); such a leaf is cut to the logical rows
        and zero-padded to this run's shape.  Any other shape mismatch
        raises :class:`CheckpointTopologyError` naming the saved topology
        and ``topology`` (this run's)."""
        def pack(s, loaded):
            state, meta = loaded
            return (s, state, meta) if return_meta else (s, state)

        pinned = step is not None
        candidates = [int(step)] if pinned else list(reversed(self.steps()))
        agree = self._agreement()
        last_err: Optional[Exception] = None
        for i in range(len(candidates) + 1):
            s = candidates[i] if i < len(candidates) else -1
            loaded = err = None
            if s >= 0:
                try:
                    loaded = self._load(s, like, elastic, topology)
                except CheckpointCorruptError as e:
                    err = e
                except Exception as e:
                    if agree is None:
                        raise
                    err = e
            if agree is not None:
                status = 2 if loaded is not None else \
                    1 if isinstance(err, CheckpointCorruptError) else 0
                lo, neg_hi, worst = agree([s, -s, status])
                if lo != -neg_hi:
                    raise CheckpointError(
                        "the processes restoring %r disagree on the "
                        "candidate step (%d..%d): was a save committed "
                        "during the restore?" % (self.directory, lo,
                                                 -neg_hi))
                if s >= 0 and worst == 0:
                    raise err if status == 0 else CheckpointError(
                        "checkpoint %s: another process failed to restore "
                        "it" % (_STEP_FMT % s))
                if s >= 0 and worst == 1 and err is None:
                    err = CheckpointCorruptError(
                        "a file another process reads is corrupt")
            if s < 0:
                break
            if err is None:
                return pack(s, loaded)
            if pinned:
                raise err
            warnings.warn(
                "checkpoint %s is corrupt (%s); falling back to the "
                "previous one" % (_STEP_FMT % s, err), stacklevel=2)
            last_err = err
        if not candidates:
            raise CheckpointError(
                "no checkpoints under %r" % self.directory)
        raise CheckpointError(
            "no intact checkpoint under %r (%d candidate(s), newest "
            "error: %s)" % (self.directory, len(candidates), last_err))

    def _agreement(self):
        """With several processes in a ``torch.distributed`` group, the
        function that takes the elementwise min of a few ints over them
        (``None`` otherwise).  Each process of a restore reads only the
        files holding its rows, so only the process reading a corrupt
        file sees it; the processes agree on the step, or all refuse."""
        from . import distributed as _dist

        if self.process_count <= 1 or not _dist.is_initialized():
            return None
        return _dist.min_over_processes

    def _load(self, step: int, like, elastic=None, topology=None):
        d = self._step_dir(step)
        try:
            raw = _with_retries(
                lambda: _read_bytes(os.path.join(d, _MANIFEST)),
                self.retries, self.backoff)
            manifest = json.loads(raw.decode())
        except FileNotFoundError as e:
            raise CheckpointCorruptError("missing manifest: %s" % e)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError("unreadable manifest: %s" % e)
        if manifest.get("format_version") != _FORMAT_VERSION:
            raise CheckpointCorruptError(
                "manifest format_version %r != %d"
                % (manifest.get("format_version"), _FORMAT_VERSION))
        flat = _flatten(like)
        entries = manifest.get("arrays", [])
        meta_topo = manifest.get("meta", {}).get("topology") \
            if isinstance(manifest.get("meta"), dict) else None
        if meta_topo is not None and topology is not None:
            mismatch = _topology_mismatch(meta_topo, topology)
            if mismatch:
                raise CheckpointTopologyError(
                    "checkpoint step %d cannot be re-sharded onto this "
                    "run's topology: %s (saved topology: %s; current "
                    "topology: %s)"
                    % (step, mismatch, json.dumps(meta_topo,
                                                  sort_keys=True),
                       json.dumps(topology, sort_keys=True)))
        if len(entries) != len(flat):
            if meta_topo is not None and topology is not None \
                    and meta_topo != topology:
                raise CheckpointTopologyError(
                    "checkpoint step %d has %d state leaves but this "
                    "run expects %d — it was saved under a different "
                    "training topology that cannot be re-sharded "
                    "(saved topology: %s; current topology: %s)"
                    % (step, len(entries), len(flat),
                       json.dumps(meta_topo, sort_keys=True),
                       json.dumps(topology, sort_keys=True)))
            raise CheckpointCorruptError(
                "manifest has %d arrays, expected %d (training state "
                "structure changed?)" % (len(entries), len(flat)))
        flat_el: List[Any] = [None] * len(flat)
        if elastic is not None:
            flat_el = [v for _, v in _flatten(elastic, none_is_leaf=True)]
            if len(flat_el) != len(flat):
                raise ValueError("elastic policy tree is not congruent "
                                 "with the state tree")
        leaves = []
        for (key, lk), entry, el in zip(flat, entries, flat_el):
            if entry.get("key") != key:
                raise CheckpointCorruptError(
                    "manifest entry %r does not match state leaf %r"
                    % (entry.get("key"), key))
            try:
                leaves.append(self._load_leaf(
                    d, entry, lk, elastic_dim=el, saved_topology=meta_topo,
                    topology=topology))
            except (CheckpointCorruptError, CheckpointTopologyError):
                raise
            except (KeyError, IndexError, TypeError, ValueError) as e:
                # manifest content that parses but decodes to garbage is
                # corruption: the last-good fallback must still engage
                raise CheckpointCorruptError(
                    "undecodable manifest entry %r: %s" % (key, e))
        return _unflatten(like, iter(leaves)), manifest.get("meta")

    def _load_leaf(self, d: str, entry: Dict, like, elastic_dim=None,
                   saved_topology=None, topology=None):
        name = entry["dtype"]
        dtype = _storage_dtype(name)
        shape = tuple(entry["shape"])
        want_shape = tuple(like.shape) if isinstance(like, Shard) \
            else tuple(np.shape(like))
        if shape != want_shape:
            self._check_elastic(entry, shape, want_shape, elastic_dim,
                                saved_topology, topology)
        if isinstance(like, Shard):
            lo, hi = like.rows
            # the rows past the logical ones are padding: zeros
            stop = hi if shape == want_shape else \
                max(lo, min(hi, int(elastic_dim)))
            arr = np.zeros((hi - lo,) + shape[1:], dtype)
            arr[:stop - lo] = self._read_rows(d, entry, dtype, lo, stop)
            return _place(arr, name, like)
        arr = self._read_all(d, entry, dtype)
        if shape != want_shape:
            arr = self._elastic_reshape(arr, want_shape, elastic_dim)
        return _place(arr, name, like)

    def _read_all(self, d: str, entry: Dict, dtype) -> np.ndarray:
        """The whole saved leaf: its one file, or its shards' files (one
        per distinct shard) put in place."""
        shape = tuple(entry["shape"])
        files = entry["files"]
        if len(files) == 1 and files[0].get("index") is None:
            return self._read_part(d, files[0], dtype).reshape(shape)
        arr = np.empty(shape, dtype)
        for f in files:
            arr[_index_from_json(f["index"])] = self._read_part(
                d, f, dtype).reshape(tuple(f["part_shape"]))
        return arr

    def _read_rows(self, d: str, entry: Dict, dtype, lo: int,
                   hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of a saved leaf, read from the files that
        hold them alone where every file holds whole rows (the leaf whole
        where it was saved as one file, or split on another dim)."""
        shape = tuple(entry["shape"])
        blocks = [(f, _index_from_json(f["index"])) for f in entry["files"]
                  if f.get("index") is not None]
        if len(blocks) < len(entry["files"]) or any(
                sl.indices(n)[:2] != (0, n)
                for _, idx in blocks for sl, n in zip(idx[1:], shape[1:])):
            return self._read_all(d, entry, dtype)[lo:hi]
        out = np.empty((hi - lo,) + shape[1:], dtype)
        covered = np.zeros(hi - lo, bool)
        for f, idx in blocks:
            f_lo, f_hi, _ = idx[0].indices(shape[0])
            if f_hi <= lo or f_lo >= hi:
                continue
            part = self._read_part(d, f, dtype) \
                .reshape(tuple(f["part_shape"]))
            a, b = max(lo, f_lo), min(hi, f_hi)
            out[a - lo:b - lo] = part[a - f_lo:b - f_lo]
            covered[a - lo:b - lo] = True
        if not covered.all():
            raise CheckpointCorruptError(
                "%s: rows %d..%d are in no file of the manifest"
                % (entry.get("key"), lo, hi))
        return out

    @staticmethod
    def _check_elastic(entry: Dict, shape: Tuple, want_shape: Tuple,
                       elastic_dim, saved_topology, topology) -> None:
        """Only the padded leading dim of a leaf marked with its logical
        rows may change across topologies; any other shape change is a
        topology refusal, not corruption."""
        ok = (elastic_dim is not None and len(shape) == len(want_shape)
              and len(shape) >= 1 and shape[1:] == want_shape[1:]
              and shape[0] >= int(elastic_dim)
              and want_shape[0] >= int(elastic_dim))
        if ok:
            return
        topo = ""
        if saved_topology is not None or topology is not None:
            topo = " (saved topology: %s; current topology: %s)" % (
                json.dumps(saved_topology, sort_keys=True),
                json.dumps(topology, sort_keys=True))
        raise CheckpointTopologyError(
            "checkpoint leaf %r was saved with shape %s but this "
            "run expects %s — only the padded leading dim of a "
            "ZeRO-sharded optimizer-state leaf can be re-sharded "
            "across topologies%s" % (entry.get("key"), list(shape),
                                     list(want_shape), topo))

    @staticmethod
    def _elastic_reshape(arr: np.ndarray, want_shape: Tuple,
                         elastic_dim) -> np.ndarray:
        """Cut a checked leaf to its logical rows and zero-pad it to this
        run's width (the pad rows are inert under the elementwise
        update)."""
        logical = int(elastic_dim)
        out = arr[:logical]
        if want_shape[0] > logical:
            pad = np.zeros((want_shape[0] - logical,) + tuple(want_shape[1:]),
                           arr.dtype)
            out = np.concatenate([out, pad], axis=0)
        return np.ascontiguousarray(out)

    def _read_part(self, d: str, f: Dict, dtype) -> np.ndarray:
        path = os.path.join(d, f["file"])
        try:
            buf = _with_retries(lambda: _read_bytes(path),
                                self.retries, self.backoff)
        except FileNotFoundError as e:
            raise CheckpointCorruptError("missing array file: %s" % e)
        if len(buf) != int(f["nbytes"]):
            raise CheckpointCorruptError(
                "%s: %d bytes on disk, manifest says %d (torn write?)"
                % (f["file"], len(buf), f["nbytes"]))
        if not _verify_checksum(buf, f["checksum"], f.get("crc32")):
            raise CheckpointCorruptError(
                "%s: checksum mismatch (%s)" % (f["file"], f["checksum"]))
        return np.frombuffer(buf, dtype)


# ---------------------------------------------------------------------------
# preemption: SIGTERM -> checkpoint at the next step boundary
# ---------------------------------------------------------------------------

# a monotonically increasing request sequence (an int increment is atomic
# under the GIL, safe from a signal handler).  Each attached step loop
# remembers the last sequence it honored, so one request reaches every
# loop instead of the first to reach a boundary.
_CKPT_SEQ = 0


def request_checkpoint() -> None:
    """Ask every step loop with an attached manager to checkpoint at its
    next step boundary (what the SIGTERM hook calls)."""
    global _CKPT_SEQ
    _CKPT_SEQ += 1


def request_seq() -> int:
    """Current request sequence number (consumers compare-and-store)."""
    return _CKPT_SEQ


def checkpoint_requested(since: int = 0) -> bool:
    """True when a checkpoint request newer than ``since`` is pending."""
    return _CKPT_SEQ > since


# signum -> the handler we displaced; a key means our hook owns it
_HOOK_PREVIOUS: Dict[int, Any] = {}


def install_preemption_hook(signals=(signal.SIGTERM,), chain=True):
    """Install handlers that request a checkpoint on preemption signals
    (main thread only).  The handler only bumps the request sequence; the
    save happens at the next step boundary, where device state is
    consistent.  ``chain=True`` forwards to the displaced handler.
    Returns ``{signum: previous_handler}``.

    Idempotent: a signal already carrying this hook is left as it is.  If
    installing one handler raises, the ones already installed are rolled
    back before the error propagates."""
    installed_now = {}
    try:
        for s in signals:
            s = int(s)
            if s in _HOOK_PREVIOUS and getattr(
                    signal.getsignal(s), "_mxtpu_preemption_hook", False):
                continue

            def _handler(signum, frame):
                request_checkpoint()
                prev = _HOOK_PREVIOUS.get(signum)
                if chain and callable(prev):
                    prev(signum, frame)

            _handler._mxtpu_preemption_hook = True
            prev = signal.signal(s, _handler)
            installed_now[s] = prev
            if not getattr(prev, "_mxtpu_preemption_hook", False):
                # never chain onto our own stale hook: that would
                # multiply every request
                _HOOK_PREVIOUS[s] = prev
            elif s not in _HOOK_PREVIOUS:
                _HOOK_PREVIOUS[s] = None
    except BaseException:
        for s, prev in installed_now.items():
            _HOOK_PREVIOUS.pop(s, None)
            try:
                signal.signal(
                    s, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError):  # pragma: no cover
                pass
        raise
    return {int(s): _HOOK_PREVIOUS[int(s)] for s in signals}


def uninstall_preemption_hook(signals=None):
    """Restore the dispositions :func:`install_preemption_hook` displaced
    (all of them with ``signals=None``); returns the restored
    ``{signum: handler}``.  The step loop calls it when a
    preemption-requested save fails, so a repeated signal terminates the
    process instead of requesting another doomed save."""
    sigs = list(_HOOK_PREVIOUS) if signals is None else \
        [int(s) for s in signals]
    restored = {}
    for s in sigs:
        if s not in _HOOK_PREVIOUS:
            continue
        prev = _HOOK_PREVIOUS.pop(s)
        try:
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        except (ValueError, OSError) as e:  # non-main thread / bad signum
            warnings.warn("could not restore handler for signal %d: %s"
                          % (s, e))
            continue
        restored[s] = prev
    return restored
