"""``mx.monitor``: statistics of every op output (port of
``incubator_mxnet_tpu/monitor.py``, ``python/mxnet/monitor.py``),
installed on an executor's monitor callback.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collects ``stat_func`` of every op output each ``interval``
    batches (default: the mean absolute value)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.abs().mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, Any]] = []
        self.step = 0
        self.exes: List[Any] = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        # the executor skips the callback on batches it does not collect
        stat_helper.is_active = lambda: self.activated
        self.stat_helper = stat_helper

    def install(self, exe, monitor_all=False):
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if the interval hits."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the batch: ``[(step, name, stat as str)]``."""
        if not self.activated:
            return []
        self.activated = False
        queue = sorted(self.queue, key=lambda x: x[1]) if self.sort \
            else self.queue
        res = [(n, k, str(v.asnumpy() if isinstance(v, NDArray) else v))
               for n, k, v in queue]
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            print("Batch: {:7d} {:30s} {:s}".format(n, k, v))
        return res
