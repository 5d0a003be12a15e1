#!/usr/bin/env python
"""The ghost-BN kernels against their bandwidth yardstick, on the card
(PyTorch/CUDA port of ``tools/bn_kernel_bench.py``).

For every ResNet-50 BN shape at batch 256 this times, with CUDA events:

* ``copy`` -- K7 ``bn_copy`` (``csrc/bn_copy.cu``): a copy of the
  activation with K1's own grid (C, G) and slice walk, so its time is the
  ceiling of K1's access pattern;
* ``fwd`` -- K1 ``ghost_bn_fwd``, one read of X (and of the residual), one
  write of Y;
* ``bwd`` -- K2 ``ghost_bn_bwd``;
* ``plain_torch`` -- the plain PyTorch ghost BN (``fused_bn._gbn_fwd_plain``,
  and its autograd backward for ``plain_torch_fwd_bwd``) on the same
  inputs: the JAX tool's ``stock_xla`` reference column, named for what
  it is here.

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
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch

from incubator_mxnet_tpu_torch import context
from incubator_mxnet_tpu_torch.base import torch_dtype
from incubator_mxnet_tpu_torch.parallel import fused_bn as fb

HBM_PEAK_GBS = 3350.0
GROUP = 16

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
    (``bwd``)."""
    time_ms = _timer(device)
    x, gamma, beta, res, ng = leg.x, leg.gamma, leg.beta, leg.res, leg.ng
    gb = leg.tensor_gb
    ms = time_ms(lambda: fb.bn_copy(x, ng), iters, warmup)
    leg.put("copy", ms, 2 * gb)
    ms = time_ms(lambda: fb.ghost_bn_fwd(x, gamma, beta, res, 1e-3, "relu",
                                         ng), iters, warmup)
    leg.put("fwd", ms, gb * (3 if leg.residual else 2))

    y, m, v = fb.ghost_bn_fwd(x, gamma, beta, res, 1e-3, "relu", ng)
    gy = x * 0.1
    gy2 = x * 0.3 if leg.dual else None
    ys = y if leg.residual else None
    ms = time_ms(lambda: fb.ghost_bn_bwd(gy, gy2, x, ys, gamma, beta, m, v,
                                         1e-3, "relu", ng), iters, warmup)
    leg.put("bwd", ms, gb * ((6 if leg.dual else 5) if leg.residual else 3))


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
    args = ap.parse_args(argv)
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
