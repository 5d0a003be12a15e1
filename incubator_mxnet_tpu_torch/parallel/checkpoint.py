"""Atomic checkpoints of training state (port of
``incubator_mxnet_tpu/parallel/checkpoint.py``, the single-process
manager).

- **manifest** — per leaf its tree key, dtype, shape, files and
  checksums, so restore verifies every file before touching live state;
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
``crc32:`` checksums, ``meta``) and raw little-endian payloads, so a
checkpoint written by either package restores in the other.  A state is
a tree of dicts, lists and tuples whose leaves are ``torch.Tensor`` s or
numpy arrays; it is flattened as ``jax.tree_util`` flattens it (dict
keys sorted, sequences by index, ``None`` no leaf) and keyed with the
strings ``jax.tree_util.keystr`` gives (``['opt_state'][3][1]``).
bfloat16 leaves travel as their 16-bit patterns.

One process only: the multi-process commit protocol and the elastic
multi-process restore wait for ROADMAP A8 item 1b.
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
           "CheckpointTopologyError", "CheckpointManager",
           "checkpoint_requested", "install_preemption_hook",
           "request_checkpoint", "request_seq",
           "uninstall_preemption_hook"]

_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_STEP_FMT = "step-%08d"
_TMP_PREFIX = ".tmp-"
_DISCARD_PREFIX = ".discard-"


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


def _leaf_bytes(leaf) -> Tuple[str, List[int], bytes]:
    """``(dtype name, shape, raw little-endian bytes)`` of a tensor (any
    device) or an array."""
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
    ``like``'s device, or a numpy array, in the saved dtype."""
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
    """Write, flush and fsync one file."""
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
    write.  ``process_count`` above 1 (the multi-process commit) waits for
    ROADMAP A8 item 1b and raises."""

    def __init__(self, directory: str, keep_last: int = 3, retries: int = 2,
                 backoff: float = 0.05, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.directory = str(directory)
        if keep_last is not None and int(keep_last) < 1:
            raise ValueError("keep_last must be >= 1 or None, got %r"
                             % (keep_last,))
        self.keep_last = None if keep_last is None else int(keep_last)
        self.retries = int(retries)
        self.backoff = float(backoff)
        if int(process_count or 1) > 1 or int(process_index or 0) != 0:
            raise NotImplementedError(
                "multi-process checkpoints (process_count %s, process_index "
                "%s) wait for the multi-process checkpoint commit, ROADMAP "
                "A8 item 1b: the port's manager commits from one process"
                % (process_count, process_index))
        self.process_index = 0
        self.process_count = 1

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

    # -- save -----------------------------------------------------------
    def save(self, step: int, state, meta: Optional[Dict] = None) -> str:
        """Stage and atomically commit ``state`` as checkpoint ``step``;
        returns the committed directory.  ``meta`` — an optional
        JSON-safe dict (the data iterator's position, the topology)
        committed with the arrays in the manifest."""
        step = int(step)
        flat = _flatten(state)
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, _TMP_PREFIX + (_STEP_FMT % step))
        final = self._step_dir(step)
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

    def _sweep_stale(self):
        """Remove staging and discard debris of crashed earlier saves:
        one writer owns the directory, so it is all orphaned."""
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX) or name.startswith(
                    _DISCARD_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _save_leaf(self, tmp: str, name: str, key: str, leaf) -> Dict:
        dtype, shape, data = _leaf_bytes(leaf)
        entry = {"key": key, "dtype": dtype, "shape": shape, "spec": None,
                 "files": []}
        entry["files"].append(self._write_payload(
            tmp, name + ".bin", data, index=None, part_shape=shape))
        return entry

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
        """Delete the committed steps beyond ``keep_last``."""
        if self.keep_last is None:
            return
        for s in self.steps()[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------
    def restore(self, like, step: Optional[int] = None,
                return_meta: bool = False, elastic=None, topology=None):
        """Load the newest intact checkpoint (or exactly ``step``) into
        the structure of ``like``; returns ``(step, state)``, or ``(step,
        state, meta)`` with ``return_meta=True``.  Each restored leaf is
        of ``like``'s kind (a tensor on its device, or a numpy array) in
        the saved dtype.  Corrupt candidates are skipped with a warning
        unless ``step`` pinned one.

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

        if step is not None:
            return pack(int(step), self._load(int(step), like, elastic,
                                              topology))
        candidates = list(reversed(self.steps()))
        if not candidates:
            raise CheckpointError(
                "no checkpoints under %r" % self.directory)
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                return pack(s, self._load(s, like, elastic, topology))
            except CheckpointCorruptError as e:
                warnings.warn(
                    "checkpoint %s is corrupt (%s); falling back to the "
                    "previous one" % (_STEP_FMT % s, e), stacklevel=2)
                last_err = e
        raise CheckpointError(
            "no intact checkpoint under %r (%d candidate(s), newest "
            "error: %s)" % (self.directory, len(candidates), last_err))

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
        files = entry["files"]
        if len(files) == 1 and files[0].get("index") is None:
            arr = self._read_part(d, files[0], dtype).reshape(shape)
        else:
            # a leaf saved sharded, one file per distinct shard
            arr = np.empty(shape, dtype)
            for f in files:
                part = self._read_part(d, f, dtype) \
                    .reshape(tuple(f["part_shape"]))
                arr[_index_from_json(f["index"])] = part
        want_shape = tuple(np.shape(like))
        if shape != want_shape:
            arr = self._elastic_reshape(entry, arr, want_shape,
                                        elastic_dim, saved_topology,
                                        topology)
        return _place(arr, name, like)

    def _elastic_reshape(self, entry: Dict, arr: np.ndarray,
                         want_shape: Tuple, elastic_dim,
                         saved_topology, topology) -> np.ndarray:
        """Re-shard a topology-dependent leaf: cut its leading dim to the
        logical rows and zero-pad to this run's width (the pad rows are
        inert under the elementwise update).  Any other shape change is
        a topology refusal, not corruption."""
        shape = tuple(arr.shape)
        ok = (elastic_dim is not None and len(shape) == len(want_shape)
              and len(shape) >= 1 and shape[1:] == want_shape[1:]
              and shape[0] >= int(elastic_dim)
              and want_shape[0] >= int(elastic_dim))
        if not ok:
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
