#!/usr/bin/env python
"""The ghost-BN kernels against their bandwidth yardstick, on the card
(PyTorch/CUDA port of ``tools/bn_kernel_bench.py``).

For every ResNet-50 BN shape at batch 256 this times, each kernel by the
profiler's device time a launch with the L2 flushed before every launch
(:func:`flushed_device_ms`), as a ResNet step finds its activations:

* ``copy`` -- K7 ``bn_copy`` (``csrc/bn_copy.cu``): a copy of the
  activation over ghost-BN blocks with the walk of
  ``csrc/ghost_bn_walk.cuh`` (contiguous runs of a few channels, 16 bytes
  a thread), so its time is the ceiling of the walk K1 and K2 take;
* ``fwd`` -- K1 ``ghost_bn_fwd``, one read of X (and of the residual), one
  write of Y; over ``copy`` it is what K1 costs beyond the walk;
* ``bwd`` -- K2 ``ghost_bn_bwd``;
* ``plain_torch`` -- the plain PyTorch ghost BN (``fused_bn._gbn_fwd_plain``,
  and its autograd backward for ``plain_torch_fwd_bwd``) on the same
  inputs, by CUDA events: the JAX tool's ``stock_xla`` reference column,
  named for what it is here.

The rows keep the JAX tool's schema, with ``stock_xla`` renamed
``plain_torch``.  The TPU plan's columns stay: the port has one kernel
form per direction (``variant`` ``k1``, ``bwd_variant`` ``k2``), no lane
fold (``fold`` 1), no spatial tiles (``l_tile`` 0) and no VMEM window
(``window_mb`` 0).  Rates are against the H100's 3.35 TB/s.

On the card, from the repository root::

    python3 tools/bn_kernel_bench_torch.py [--format json] [--out rows.jsonl]

``--dry-run`` runs three tiny shapes on the CPU through the plain versions
(K7's is ``x.clone()``): it checks the tool end to end, and its times are
the CPU's, not the card's.

``--before DIR`` times, instead, K7, K1, K2 and R1 (the rtc
``scale_kernel``) as the tree unpacked under DIR has them against this
tree's, on the same flushed clock and in the order before, now, library
call, now, before: K7 beside ``Tensor.copy_`` at the 9 shapes in bf16,
K1 and K2 at the 9 shapes in bf16 (no library call computes them: the
order is before, now, now, before), R1 beside ``torch.add(1, x,
alpha=2)`` over (4, 8, 2048, 128) f32.  DIR's K7, K1 and K2 are built by
``nvcc`` under ``build/before/`` (through the same C entries as this
tree's), its R1 by NVRTC, each launched on its own grid::

    git archive <commit> | tar -x -C build/before_tree
    python3 tools/bn_kernel_bench_torch.py --before build/before_tree
"""
import argparse
import collections
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch

from incubator_mxnet_tpu_torch import _kernels, context
from incubator_mxnet_tpu_torch.base import torch_dtype
from incubator_mxnet_tpu_torch.parallel import fused_bn as fb

HBM_PEAK_GBS = 3350.0
GROUP = 16
#: bytes written before every flushed launch: over twice the H100's 50 MB L2
FLUSH_BYTES = 256 << 20

SHAPES = [
    # (N, C, H, W): every distinct BN shape in ResNet-50 v1 at batch 256
    (256, 64, 112, 112),
    (256, 64, 56, 56),
    (256, 256, 56, 56),
    (256, 128, 28, 28),
    (256, 512, 28, 28),
    (256, 256, 14, 14),
    (256, 1024, 14, 14),
    (256, 512, 7, 7),
    (256, 2048, 7, 7),
]

DRY_SHAPES = [
    (64, 32, 4, 4),
    (32, 128, 6, 6),
    (32, 128, 2, 2),
]

COLS = ("shape", "residual", "dual", "variant", "bwd_variant", "fold",
        "l_tile", "window_mb", "copy_ms", "fwd_ms", "bwd_ms",
        "plain_torch_ms", "plain_torch_fwd_bwd_ms")


def _timer(device):
    """``time(fn, iters, warmup)`` in ms a call: CUDA events on the card,
    the host clock on the CPU."""
    def time_ms(fn, iters, warmup):
        for _ in range(warmup):
            fn()
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    return time_ms


#: the flush's kernel: a uint8 fill, which no timed function launches
FLUSH_KERNEL = "FillFunctor<unsigned char>"
#: profiler sessions per measurement: the trace can come back empty or
#: cut short, and is then taken again
SESSIONS = 3
#: flushed calls a session runs before the ones it reads, and the host's
#: pause before them: the profiler can miss a session's first events (11
#: calls of K3 at a zoo shape in three sessions running, in one H100 run)
WARMUP_CALLS = 32
START_PAUSE_S = 0.02
#: sessions taken again since the process started (printed by
#: chip_smoke.py beside its flushed times)
retried = 0


def _flushed_calls(fn, iters, device):
    """One profiler session of ``WARMUP_CALLS + iters`` flushed calls: the
    events of each call after its flush, ``[[(name, ms), ...], ...]``,
    and the count of every event name in the trace."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(START_PAUSE_S)
        for i in range(WARMUP_CALLS + iters):
            flush.fill_(i % 200 + 1)
            fn()
        torch.cuda.synchronize(device)
    events = sorted((ev.time_range.start, ev.name, ev.time_range.elapsed_us())
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    calls = []
    for _, n, us in events:
        if FLUSH_KERNEL in n:
            calls.append([])
        elif calls:
            calls[-1].append((n, us / 1e3))
    return calls, collections.Counter(n for _, n, _ in events)


def flushed_device_ms(fn, iters, device, name=None):
    """Mean device time in ms a call of ``fn`` on the card, with the L2
    flushed before every call: ``FLUSH_BYTES`` written by one uint8 fill
    just before it.  The clock is torch.profiler's CUDA trace, so a kernel
    and a library call are timed alike: the device time of the kernel
    whose name holds ``name`` (which ``fn`` must launch once a call), or
    with ``name`` None of every kernel or copy ``fn`` runs.

    The trace is split into calls at the flushes (``FLUSH_KERNEL``), so a
    fill of another dtype that ``fn`` launches is timed with it.  The
    profiler can miss the first events of a session, or all of them, so
    ``WARMUP_CALLS`` flushed calls run first inside it (after a pause of
    ``START_PAUSE_S``), only the last
    ``iters`` calls are read, and a trace without them is taken again, up
    to ``SESSIONS`` times (counted in ``retried``)."""
    global retried

    fn()
    torch.cuda.synchronize(device)
    for session in range(SESSIONS):
        calls, names = _flushed_calls(fn, iters, device)
        calls = calls[-iters:]
        hits = [sum(name is None or name in n for n, _ in c) for c in calls]
        if len(calls) == iters and min(hits) >= 1 and \
                (name is None or max(hits) == 1):
            return sum(ms for c in calls for n, ms in c
                       if name is None or name in n) / iters
        if session + 1 < SESSIONS:
            retried += 1
    raise AssertionError(
        "in %d sessions the profiler saw at last %s over %d flushes, want "
        "%d calls each of a flush and %s" % (
            SESSIONS, sorted(names.items()), len(calls), iters,
            "one launch of %s" % name if name else "fn's work"))


class Leg:
    """One row to bench: its fixed columns (``row``) and its inputs."""

    def __init__(self, n, c, h, w, dtype, residual, dual, device):
        itemsize = torch.finfo(dtype).bits // 8
        self.tensor_gb = n * c * h * w * itemsize / 1e9
        self.residual, self.dual = bool(residual), bool(dual)
        self.ng = fb.ghost_group(n, c, h, w, itemsize, GROUP, residual, False,
                                 dual)
        g = torch.Generator(device=device).manual_seed(0)
        self.x = torch.randn(n, c, h, w, generator=g, device=device).to(dtype)
        self.gamma = torch.ones(c, device=device)
        self.beta = torch.zeros(c, device=device)
        self.res = self.x * 0.5 if residual else None
        self.row = {"shape": "%dx%dx%dx%d" % (n, c, h, w),
                    "dtype": str(dtype).replace("torch.", ""),
                    "residual": self.residual, "dual": self.dual,
                    "variant": "k1", "bwd_variant": "k2", "fold": 1,
                    "l_tile": 0, "l_tile_bwd": 0, "window_mb": 0.0}

    def put(self, key, ms, nbytes_gb):
        """The row's ``key`` columns: ms a call, GB/s, share of the peak."""
        self.row[key + "_ms"] = round(ms, 4)
        self.row[key + "_gbs"] = round(nbytes_gb / (ms / 1e3), 1)
        self.row[key + "_pct_peak"] = round(
            100 * (nbytes_gb / (ms / 1e3)) / HBM_PEAK_GBS, 1)


def bench_plain(leg, device, iters=20, warmup=3):
    """The plain torch ghost BN columns of ``leg``: its forward, and its
    forward with the autograd backward."""
    time_ms = _timer(device)
    x, gamma, beta, res, ng = leg.x, leg.gamma, leg.beta, leg.res, leg.ng
    gb = leg.tensor_gb
    ms = time_ms(lambda: fb._gbn_fwd_plain(x, gamma, beta, res, 1e-3, "relu",
                                           ng), iters, warmup)
    leg.put("plain_torch", ms, gb * (3 if leg.residual else 2) + gb)

    xg = x.detach().requires_grad_()
    rg = res.detach().requires_grad_() if leg.residual else None
    leaves = [xg, rg] if leg.residual else [xg]

    def plain_fwd_bwd():
        y, _, _ = fb._gbn_fwd_plain(xg, gamma, beta, rg, 1e-3, "relu", ng)
        torch.autograd.grad((y.float() ** 2).sum(), leaves)

    ms = time_ms(plain_fwd_bwd, iters, warmup)
    leg.put("plain_torch_fwd_bwd", ms, gb * (8 if leg.residual else 6))


def bench_kernels(leg, device, iters=20, warmup=3):
    """The kernel columns of ``leg``: K7 (``copy``), K1 (``fwd``) and K2
    (``bwd``), on the card by :func:`flushed_device_ms`."""
    if device.type == "cuda":
        def time_ms(fn, iters, warmup, name):
            return flushed_device_ms(fn, iters, device, name)
    else:
        host = _timer(device)

        def time_ms(fn, iters, warmup, name):
            return host(fn, iters, warmup)
    x, gamma, beta, res, ng = leg.x, leg.gamma, leg.beta, leg.res, leg.ng
    gb = leg.tensor_gb
    ms = time_ms(lambda: fb.bn_copy(x, ng), iters, warmup, "bn_copy_kernel")
    leg.put("copy", ms, 2 * gb)
    ms = time_ms(lambda: fb.ghost_bn_fwd(x, gamma, beta, res, 1e-3, "relu",
                                         ng), iters, warmup, "ghost_bn_fwd")
    leg.put("fwd", ms, gb * (3 if leg.residual else 2))

    y, m, v = fb.ghost_bn_fwd(x, gamma, beta, res, 1e-3, "relu", ng)
    gy = x * 0.1
    gy2 = x * 0.3 if leg.dual else None
    ys = y if leg.residual else None
    ms = time_ms(lambda: fb.ghost_bn_bwd(gy, gy2, x, ys, gamma, beta, m, v,
                                         1e-3, "relu", ng), iters, warmup,
                 "ghost_bn_bwd")
    leg.put("bwd", ms, gb * ((6 if leg.dual else 5) if leg.residual else 3))


def _before_lib(before, source):
    """The ``ctypes`` library of ``csrc/<source>`` of the tree under
    ``before``, built by nvcc into ``build/before/``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stem = os.path.splitext(source)[0]
    out = os.path.join(root, "build", "before", stem + "_before.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = os.path.join(before, "incubator_mxnet_tpu_torch", "csrc", source)
    subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS, "-shared", src,
                    "-o", out], check=True)
    return ctypes.CDLL(out)


def _entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = _kernels._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def before_ghost_bn(before, device):
    """``(fwd, bwd)`` through the K1 and K2 of the tree under ``before``
    (same C entries as this tree's), with the signatures of
    ``fused_bn.ghost_bn_fwd`` and ``ghost_bn_bwd`` on card tensors."""
    lib = _before_lib(before, "ghost_bn.cu")
    efwd, ebwd = _entry(lib, "ghost_bn_fwd"), _entry(lib, "ghost_bn_bwd")

    def ptr(t):
        return None if t is None else t.data_ptr()

    def check(err, name):
        if err:
            raise RuntimeError("the earlier %s failed: CUDA error %d"
                               % (name, err))

    def fwd(x, gamma, beta, residual, eps, act, ng):
        n, c, h, w = x.shape
        y = torch.empty_like(x)
        mean = torch.empty((n // ng, c), dtype=torch.float32, device=x.device)
        var = torch.empty_like(mean)
        check(efwd(fb._DTYPE_CODE[x.dtype], ptr(x), ptr(residual), ptr(gamma),
                   ptr(beta), ptr(y), ptr(mean), ptr(var), n // ng, c, h * w,
                   ng, float(eps), int(act == "relu"),
                   torch.cuda.current_stream(device).cuda_stream),
              "ghost_bn_fwd")
        return y, mean, var

    def bwd(gy, gy2, x, y, gamma, beta, mean, var, eps, act, ng):
        n, c, h, w = x.shape
        dx = torch.empty_like(x)
        dr = torch.empty_like(x) if y is not None else None
        dg = torch.empty((n // ng, c), dtype=torch.float32, device=x.device)
        db = torch.empty_like(dg)
        check(ebwd(fb._DTYPE_CODE[x.dtype], ptr(gy), ptr(gy2), ptr(x), ptr(y),
                   ptr(gamma), ptr(beta), ptr(mean), ptr(var), ptr(dx),
                   ptr(dr), ptr(dg), ptr(db), n // ng, c, h * w, ng,
                   float(eps), int(act == "relu"),
                   torch.cuda.current_stream(device).cuda_stream),
              "ghost_bn_bwd")
        return dx, dg.sum(0), db.sum(0), dr

    return fwd, bwd


def before_maxpool(before, device):
    """``pool(x, window, strides, padding) -> (out, idx)`` through the K3
    of the tree under ``before`` (same C entry as this tree's), with the
    signature of ``maxpool_idx.maxpool_with_index`` on contiguous card
    tensors."""
    from incubator_mxnet_tpu_torch.parallel import maxpool_idx

    entry = _entry(_before_lib(before, "maxpool_idx.cu"), "maxpool_idx_fwd")

    def pool(x, window, strides, padding):
        n, c, h, w = x.shape
        oh, ow = maxpool_idx.check_shape(x.shape, window, strides, padding)
        out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
        idx = torch.empty((n, c, oh, ow), dtype=torch.int8, device=x.device)
        err = entry(fb._DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                    idx.data_ptr(), n, c, h, w, oh, ow, window[2], window[3],
                    strides[2], strides[3], padding[2][0], padding[3][0],
                    torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError("the earlier maxpool_idx_fwd failed: CUDA "
                               "error %d" % err)
        return out, idx

    return pool


def _before_k7(before, device):
    """``copy(x, ng)`` through the K7 of the tree under ``before`` (same C
    entry as this tree's), built by nvcc into ``build/before/``."""
    entry = _entry(_before_lib(before, "bn_copy.cu"), "bn_copy")

    def copy(x, ng):
        n, c, h, w = x.shape
        y = torch.empty_like(x)
        err = entry(fb._DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                    n // ng, c, h * w, ng,
                    torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError("the earlier bn_copy failed: CUDA error %d"
                               % err)
        return y

    return copy


def bench_before(before, device, iters):
    """K7 and R1 of the tree under ``before`` against this tree's, with
    the library call between, on the flushed clock; one row a shape."""
    from incubator_mxnet_tpu_torch import ndarray as nd, rtc

    old_copy = _before_k7(before, device)
    old_fwd, old_bwd = before_ghost_bn(before, device)
    rows = []
    for n, c, h, w in SHAPES:
        leg = Leg(n, c, h, w, torch.bfloat16, False, False, device)
        x, ng = leg.x, leg.ng
        dst = torch.empty_like(x)
        if not (torch.equal(old_copy(x, ng), x)
                and torch.equal(fb.bn_copy(x, ng), x)):
            raise AssertionError("a K7 is not exact at %s" % leg.row["shape"])
        k7 = "bn_copy_kernel"
        t = [flushed_device_ms(lambda: old_copy(x, ng), iters, device, k7),
             flushed_device_ms(lambda: fb.bn_copy(x, ng), iters, device, k7),
             flushed_device_ms(lambda: dst.copy_(x), iters, device),
             flushed_device_ms(lambda: fb.bn_copy(x, ng), iters, device, k7),
             flushed_device_ms(lambda: old_copy(x, ng), iters, device, k7)]
        rows.append(dict(kernel="bn_copy", shape=leg.row["shape"],
                         dtype="bfloat16", before_ms=[t[0], t[4]],
                         now_ms=[t[1], t[3]], library="Tensor.copy_",
                         library_ms=t[2]))
        rows.extend(_before_gbn_rows(leg, old_fwd, old_bwd, device, iters))
        del leg, x, dst
    ctx = context.gpu(device.index or 0)
    sig = rtc.USER_KERNELS["scale_kernel"]
    src = os.path.join(before, "incubator_mxnet_tpu_torch", "csrc", "rtc",
                       "scale_kernel.cu")
    with open(src) as f:
        old = rtc.CudaModule(f.read(), exports=["scale_kernel"]).get_kernel(
            "scale_kernel", sig)
    new = rtc.CudaModule(rtc.user_source("scale_kernel"),
                         exports=["scale_kernel"]).get_kernel("scale_kernel",
                                                              sig)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(4, 8, 2048, 128, generator=g, device=device)
    y = torch.empty_like(x)
    count = x.numel()
    one = torch.ones((), device=device)
    xa, ya = nd.NDArray(x), nd.NDArray(y)

    def run_old():
        old.launch([xa, ya, count], ctx, (-(-count // 256), 1, 1),
                   (256, 1, 1))

    def run_new():
        new.launch([xa, ya, count], ctx, rtc.scale_grid(count, ctx),
                   (rtc.SCALE_THREADS, 1, 1))

    for run in (run_old, run_new):
        y.zero_()
        run()
        if not torch.equal(y, rtc.scale_plain(x)):
            raise AssertionError("an R1 is not exact")
    r1 = "scale_kernel"
    t = [flushed_device_ms(run_old, iters, device, r1),
         flushed_device_ms(run_new, iters, device, r1),
         flushed_device_ms(lambda: torch.add(one, x, alpha=2), iters, device),
         flushed_device_ms(run_new, iters, device, r1),
         flushed_device_ms(run_old, iters, device, r1)]
    rows.append(dict(kernel="scale_kernel", shape="4x8x2048x128",
                     dtype="float32", before_ms=[t[0], t[4]],
                     now_ms=[t[1], t[3]], library="torch.add",
                     library_ms=t[2]))
    return rows


def _before_gbn_rows(leg, old_fwd, old_bwd, device, iters):
    """K1 and K2 of the earlier tree against this tree's on ``leg`` (relu,
    no residual), in the order before, now, now, before; the two sides'
    y must agree within 2^-7 and dx within 2^-6 of the largest magnitude
    (bf16 outputs of f32 sums taken in another order)."""
    x, gamma, beta, ng = leg.x, leg.gamma, leg.beta, leg.ng
    out = []
    y, m, v = fb.ghost_bn_fwd(x, gamma, beta, None, 1e-3, "relu", ng)
    yo, mo, vo = old_fwd(x, gamma, beta, None, 1e-3, "relu", ng)
    gy = x * 0.1
    dx = fb.ghost_bn_bwd(gy, None, x, None, gamma, beta, m, v, 1e-3, "relu",
                         ng)[0]
    dxo = old_bwd(gy, None, x, None, gamma, beta, m, v, 1e-3, "relu", ng)[0]
    scale = max(1.0, dxo.float().abs().max().item())
    if (y.float() - yo.float()).abs().max().item() > 2.0 ** -7 * max(
            1.0, yo.float().abs().max().item()) or \
            (dx.float() - dxo.float()).abs().max().item() > 2.0 ** -6 * scale:
        raise AssertionError("K1 or K2 disagrees with the earlier one at %s"
                             % leg.row["shape"])
    for kernel, new, old, name in (
            ("ghost_bn_fwd",
             lambda: fb.ghost_bn_fwd(x, gamma, beta, None, 1e-3, "relu", ng),
             lambda: old_fwd(x, gamma, beta, None, 1e-3, "relu", ng),
             "ghost_bn_fwd"),
            ("ghost_bn_bwd",
             lambda: fb.ghost_bn_bwd(gy, None, x, None, gamma, beta, m, v,
                                     1e-3, "relu", ng),
             lambda: old_bwd(gy, None, x, None, gamma, beta, m, v, 1e-3,
                             "relu", ng),
             "ghost_bn_bwd")):
        t = [flushed_device_ms(old, iters, device, name),
             flushed_device_ms(new, iters, device, name),
             flushed_device_ms(new, iters, device, name),
             flushed_device_ms(old, iters, device, name)]
        out.append(dict(kernel=kernel, shape=leg.row["shape"],
                        dtype="bfloat16", before_ms=[t[0], t[3]],
                        now_ms=[t[1], t[2]], library=None, library_ms=None))
    return out


BEFORE_HEAD = "%-12s %-12s %15s %15s %9s %9s %9s %9s" % (
    "kernel", "shape", "before ms", "now ms", "lib ms", "before/lib",
    "now/lib", "before/now")


def _before_line(row):
    """One row of ``--before``: both times of each side, the library
    call's (where there is one), and the ratios of the two sides' means."""
    before = sum(row["before_ms"]) / 2
    now = sum(row["now_ms"]) / 2
    lib = row["library_ms"]
    return "%-12s %-12s %15s %15s %9s %9s %9s %9.3f" % (
        row["kernel"], row["shape"],
        "/".join("%.4f" % t for t in row["before_ms"]),
        "/".join("%.4f" % t for t in row["now_ms"]),
        "-" if lib is None else "%.4f" % lib,
        "-" if lib is None else "%.3f" % (before / lib),
        "-" if lib is None else "%.3f" % (now / lib), before / now)


def _table_line(row):
    return " ".join("%*s" % (max(len(k), 8), row.get(k, "-")) for k in COLS)


def legs(shapes, want_res, want_dual):
    """``(n, c, h, w, residual, dual)`` for every row to bench."""
    out = []
    for n, c, h, w in shapes:
        out.append((n, c, h, w, False, False))
        if want_res and c >= 128:
            out.append((n, c, h, w, True, False))
            if want_dual:
                out.append((n, c, h, w, True, True))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", default=None, help="also append JSON rows here")
    ap.add_argument("--residual", action="store_true",
                    help="bench the residual forms too")
    ap.add_argument("--variants", action="store_true",
                    help="add the dual-cotangent residual rows (the block "
                         "exits) as well")
    ap.add_argument("--format", dest="fmt", default="table",
                    choices=["table", "json"],
                    help="json prints one JSON object per row")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dry-run", action="store_true",
                    help="three tiny shapes on the CPU through the plain "
                         "versions (times are the CPU's, not the card's)")
    ap.add_argument("--before", default=None, metavar="DIR",
                    help="time K7, K1, K2 and R1 of the tree unpacked under "
                         "DIR "
                         "against this tree's (module note)")
    args = ap.parse_args(argv)
    if args.before:
        device = context.default_device()
        print("# device=%s; L2 flushed (%d MB) before every launch; device "
              "ms a launch" % (torch.cuda.get_device_name(device),
                               FLUSH_BYTES >> 20), flush=True)
        print(BEFORE_HEAD, flush=True)
        rows = bench_before(args.before, device, args.iters)
        for row in rows:
            print(_before_line(row), flush=True)
        if args.out:
            with open(args.out, "a") as sink:
                for row in rows:
                    sink.write(json.dumps(row) + "\n")
        return
    if args.dry_run:
        device, shapes, iters, warmup = context.cpu(), DRY_SHAPES, 1, 1
    else:
        device, shapes, iters, warmup = (context.default_device(), SHAPES,
                                         args.iters, 3)
    dtype = torch_dtype(args.dtype)
    print("# device=%s%s" % (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "" if device.type == "cuda" else " (plain versions; times are NOT "
        "the card's)"), file=sys.stderr)
    if args.fmt == "table":
        print(" ".join("%*s" % (max(len(k), 8), k) for k in COLS), flush=True)
    sink = open(args.out, "a") if args.out else None
    try:
        for n, c, h, w, residual, dual in legs(
                shapes, args.residual or args.variants or args.dry_run,
                args.variants or args.dry_run):
            leg = Leg(n, c, h, w, dtype, residual, dual, device)
            bench_plain(leg, device, iters, warmup)
            bench_kernels(leg, device, iters, warmup)
            line = json.dumps(leg.row)
            print(line if args.fmt == "json" else _table_line(leg.row),
                  flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()


if __name__ == "__main__":
    main()
