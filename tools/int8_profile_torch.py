#!/usr/bin/env python
"""Where the port's int8 paths spend their time on the card.

1. The int8 serving tier's prologue: ``resnet50_v1`` (Xavier, seed 0,
   224 px) served by an f32 ``ServeEngine`` and by an int8 one at
   buckets (16, 64); each bucket program's graph replay timed by CUDA
   events (median of 10), the int8 less the f32 being the dequantize
   prologue; the prologue alone, eagerly.
2. ``bench.py --mode infer-int8``'s int8 forward (the net exported,
   ``fold_batch_norm``, ``quantize_model(calib_mode="none")``, batch
   128) through the ``Executor``: one forward under ``torch.profiler``,
   device time by op, and the share of ``torch._int_mm``.

f32 with TF32 off, cuDNN deterministic (as ``chip_smoke.py`` 3q).  Card
only::

  python3 tools/int8_profile_torch.py
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _event_ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _device_us(row):
    """A profiler row's self device time (us), under either of the names
    PyTorch has given it."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, name):
            return getattr(row, name)
    raise AttributeError("no device time in the profiler's rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=224)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.contrib.quantization import (
        fold_batch_norm, quantize_model)
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.ops.quantization import dequantize_tensor
    from incubator_mxnet_tpu_torch.serve import ServeEngine

    if not torch.cuda.is_available():
        raise SystemExit("int8_profile_torch.py times the card: no CUDA "
                         "device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    mx.random.seed(0)
    net = resnet.resnet50_v1(classes=1000, device=dev)
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1, 3, args.image, args.image))
    sample = np.zeros((3, args.image, args.image), np.float32)

    engines = {}
    for tag, dtype in (("f32", None), ("int8", "int8")):
        engines[tag] = ServeEngine(net, buckets=(16, 64), dtype=dtype)
        engines[tag].warmup(sample)
    for b in (16, 64):
        f32, int8 = (_event_ms(engines[t]._programs[(0, b)].graph.replay)
                     for t in ("f32", "int8"))
        print("bucket %d: replay f32 %.3f ms, int8 %.3f ms, prologue %.3f "
              "ms  on %s" % (b, f32, int8, int8 - f32, card), flush=True)
    slot = engines["int8"]._slots[0]
    eager = _event_ms(lambda: [dequantize_tensor(c, a, d)
                               for _p, (c, a), d in slot.quant])
    print("the prologue alone, eagerly: %.3f ms (%d tensors)  on %s"
          % (eager, len(slot.quant), card), flush=True)
    del engines, slot
    torch.cuda.empty_cache()

    directory = tempfile.mkdtemp(prefix="int8_profile_")
    try:
        prefix = os.path.join(directory, "r50")
        net.export(prefix)
        sym, arg, aux = mx.model.load_checkpoint(prefix, 0, ctx=dev)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    qsym, qargs, qaux = quantize_model(*fold_batch_norm(sym, arg, aux),
                                       calib_mode="none")
    binds = dict(qargs)
    binds["data"] = mx.nd.array(np.random.RandomState(0).uniform(
        size=(args.batch, 3, args.image, args.image)).astype(np.float32),
        ctx=dev)
    exe = qsym.bind(dev, args=binds, aux_states=qaux)
    exe.forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.forward()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # kernels are device events; an aten op's self device time is the
    # kernels it launched itself
    total = sum(_device_us(r) for r in rows
                if r.device_type == DeviceType.CUDA) / 1e3
    print("int8 forward, batch %d: %.2f ms of device time  on %s"
          % (args.batch, total, card), flush=True)
    ops = sorted((r for r in rows if r.key.startswith("aten::")
                  and _device_us(r) > 0), key=lambda r: -_device_us(r))
    for r in ops[:12]:
        ms = _device_us(r) / 1e3
        print("  %-24s %8.3f ms  %5.1f %%  %5d calls"
              % (r.key, ms, 100.0 * ms / total, r.count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
