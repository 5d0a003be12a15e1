"""Timed CUDA-graph capture for the serving layer and the persistent cache
of the built kernel library (port of the parts of
``incubator_mxnet_tpu/parallel/aot.py`` that apply on the card).

The reference compiles one AOT program per served shape and counts the
real XLA compiles (``XLA_COMPILES``).  On the card the counterpart of a
compiled program is a captured ``torch.cuda.CUDAGraph``: the kernels of
one forward at fixed shapes and addresses, replayed with one launch.

- :data:`CUDA_GRAPH_CAPTURES` counts the captures made through
  :func:`capture_timed`, process-wide, under a lock (a batcher worker may
  capture a bucket the warmup skipped while the main thread captures
  another);
- :func:`resolve_mode` is the knob order the reference's program makers
  share (an explicit argument, else an environment variable, else the
  default), kept for the lint and cost knobs that wait for the analysis
  layer;
- :func:`capture_timed` captures one callable into a new graph and
  reports the seconds it took.  It captures in ``thread_local`` error
  mode: a call that stream capture forbids raises in the capturing
  thread, and the other threads of the process (a batcher worker, a
  watchdog) go on unhindered.  A failed capture raises; nothing falls
  back to an eager run.

**The compile cache.**  The reference keeps serialized XLA executables
on disk (:class:`CompileCache`, consulted by ``compile_timed``).  CUDA
graphs are not stored: a captured graph holds one process's device
addresses and cannot outlive it, so ``compile_timed``'s ``cache=`` and
``default_compile_cache`` have no counterpart here.  The one compiled
artifact the port keeps across processes is the kernel library that
``_kernels.build`` makes with ``nvcc``
(``build/torch_kernels/libmxnet_tpu_torch_<hash>.so``, keyed by a hash
of the sources and flags), and :class:`CompileCache` holds it to the
reference's contract:

- ``hits``, ``misses``, ``dropped`` (damaged entries deleted on load) and
  ``store_failures`` count what happened;
- a stored entry gets a sha256 sidecar (``<entry>.sha256``), written
  atomically before the entry is renamed into place, and :meth:`load`
  verifies it before the entry is opened: a truncated, bit-flipped or
  garbage entry, or one whose sidecar is missing or differs, is warned
  about, deleted and rebuilt, never opened;
- a store sweeps the directory down to ``max_bytes``, removing the
  entries of other keys oldest first, never the one just stored.

:func:`~.fault_injection.corrupt_compile_cache` damages an entry.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["CUDA_GRAPH_CAPTURES", "CompileCache", "capture_timed",
           "resolve_mode"]


class _CaptureCounter:
    """Process-wide count of CUDA-graph captures made through
    :func:`capture_timed`, incremented under a lock."""

    __slots__ = ("count", "_lock")

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def bump(self):
        with self._lock:
            self.count += 1


#: the one instance every capture bumps
CUDA_GRAPH_CAPTURES = _CaptureCounter()


def resolve_mode(value: Optional[str], env_var: str, default: str,
                 allowed: Sequence[str], what: str) -> str:
    """The shared knob-resolution order: explicit argument > environment
    variable > ``default``.  Raises ``ValueError`` naming the knob on
    anything outside ``allowed``."""
    if value is None:
        value = str(os.environ.get(env_var, default) or default).lower()
    if value not in allowed:
        raise ValueError("%s must be one of %s, got %r"
                         % (what, "/".join(repr(a) for a in allowed),
                            value))
    return value


def capture_timed(fn: Callable[..., Any], *args, pool=None
                  ) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[str, float]]:
    """Capture ``fn(*args)`` into a new CUDA graph on the current device.

    Returns ``(graph, outputs, {"capture": seconds})``: ``outputs`` are
    the tensors the capture allocated (the graph's static outputs, which
    each replay rewrites).  ``pool`` shares a memory pool between graphs
    that are replayed one at a time.  The caller warms ``fn`` up eagerly
    first (kernels built, library handles and algorithms chosen)."""
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = fn(*args)
    torch.cuda.synchronize()
    CUDA_GRAPH_CAPTURES.bump()
    return graph, out, {"capture": time.perf_counter() - t0}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CompileCache:
    """A directory of built shared libraries, ``<prefix><key>.so`` each
    with a sha256 sidecar (module note).

    :meth:`load` returns ``opener(path)`` of an intact entry, or None on
    a miss or a damaged entry (deleted, with a warning).  :meth:`store`
    runs ``build(tmp_path)`` and publishes its output atomically.  The
    caller serializes builds of one key (``_kernels._build_lock``)."""

    #: bump to orphan every existing entry on a format change
    VERSION = 1
    SUFFIX = ".so"
    SIDECAR = ".sha256"

    def __init__(self, directory: str, max_bytes: int = 512 << 20,
                 prefix: str = ""):
        self.directory = str(directory)
        self.max_bytes = int(max_bytes)
        self.prefix = prefix
        self.hits = 0
        self.misses = 0
        self.dropped = 0       # damaged entries deleted on load
        self.store_failures = 0
        self._lock = threading.Lock()

    def _count(self, attr: str):
        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)

    def counters(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "dropped": self.dropped,
                "store_failures": self.store_failures}

    def path(self, key: str) -> str:
        return os.path.join(self.directory, self.prefix + key + self.SUFFIX)

    def _drop(self, path: str, why: str):
        warnings.warn("compile cache: damaged entry %s (%s) -- deleting it "
                      "and rebuilding" % (os.path.basename(path), why),
                      stacklevel=3)
        self._count("dropped")
        for p in (path, path + self.SIDECAR):
            try:
                os.remove(p)
            except OSError:
                pass

    def load(self, key: str, opener: Callable[[str], Any]):
        """``opener(path)`` of the entry for ``key`` once its sidecar
        verifies, or None (a miss, or a damaged entry now deleted)."""
        path = self.path(key)
        if not os.path.exists(path):
            self._count("misses")
            return None
        try:
            with open(path + self.SIDECAR) as f:
                recorded = f.read().split()
        except OSError:
            self._drop(path, "no sidecar")
            return None
        want = ["v%d" % self.VERSION, key]
        if len(recorded) != 3 or recorded[:2] != want:
            self._drop(path, "sidecar is not this entry's")
            return None
        try:
            digest = _sha256(path)
        except OSError as e:
            self._drop(path, "unreadable: %s" % e)
            return None
        if digest != recorded[2]:
            self._drop(path, "sha256 %s, sidecar says %s"
                       % (digest[:12], recorded[2][:12]))
            return None
        try:
            out = opener(path)
        except OSError as e:
            self._drop(path, "refused by the loader: %s" % e)
            return None
        try:  # recency for the sweep
            os.utime(path)
        except OSError:
            pass
        self._count("hits")
        return out

    def store(self, key: str, build: Callable[[str], None]) -> str:
        """Run ``build(tmp)`` (it writes the artifact at ``tmp``; its
        errors propagate), write the sidecar, rename the artifact into
        place and sweep.  Returns the path to open: the entry, or after a
        failed publish (counted, warned) the temporary file."""
        from .checkpoint import _write_bytes

        os.makedirs(self.directory, exist_ok=True)
        path = self.path(key)
        tmp = "%s.tmp.%d%s" % (path[:-len(self.SUFFIX)], os.getpid(),
                               self.SUFFIX)
        build(tmp)
        side_tmp = path + self.SIDECAR + ".tmp.%d" % os.getpid()
        try:
            record = "v%d %s %s\n" % (self.VERSION, key, _sha256(tmp))
            _write_bytes(side_tmp, record.encode())
            os.replace(side_tmp, path + self.SIDECAR)
            os.replace(tmp, path)
        except OSError as e:
            self._count("store_failures")
            warnings.warn("compile cache: failed to store %s (%s) -- "
                          "continuing uncached" % (os.path.basename(path), e),
                          stacklevel=2)
            try:
                os.remove(side_tmp)
            except OSError:
                pass
            return tmp
        self._sweep(keep=path)
        return path

    def _sweep(self, keep: str):
        """Remove other keys' entries, oldest first, until the directory's
        entries fit ``max_bytes``, and temporary files of crashed writers
        older than 300 s; ``keep`` stays whatever its size."""
        entries = []
        try:
            with os.scandir(self.directory) as it:
                for de in it:
                    if ".tmp." in de.name:
                        if time.time() - de.stat().st_mtime > 300:
                            os.remove(de.path)
                    elif de.name.startswith(self.prefix) and \
                            de.name.endswith(self.SUFFIX):
                        st = de.stat()
                        entries.append((st.st_mtime, st.st_size, de.path))
        except OSError:
            return
        total = sum(size for _, size, _ in entries)
        for _, size, path in sorted(entries):
            if total <= self.max_bytes:
                break
            if path == keep:
                continue
            for p in (path, path + self.SIDECAR):
                try:
                    os.remove(p)
                except OSError:
                    pass
            total -= size
