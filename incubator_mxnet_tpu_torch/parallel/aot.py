"""Timed CUDA-graph capture for the serving layer (port of the part of
``incubator_mxnet_tpu/parallel/aot.py`` that serving uses).

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

The reference's persistent compile cache (``CompileCache``) is not
ported yet (ROADMAP): a captured graph holds one process's device
addresses and cannot be stored as it is.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["CUDA_GRAPH_CAPTURES", "capture_timed", "resolve_mode"]


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
