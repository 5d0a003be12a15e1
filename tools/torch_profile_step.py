#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one card.

Builds the main path of ``chip_smoke.py`` (``resnet50_v1(ghost_bn=16)``,
batch 256, 224 px, bf16 compute, f32 master weights, sgd momentum 0.9 /
lr 0.1 / wd 1e-4, dynamic loss scale, synthetic data from a seed), runs
``WARMUP`` steps, then traces ``STEPS`` steps with ``torch.profiler`` and
prints:

- the wall time per step and the device's busy share (summed kernel
  time over wall time; the rest is the card waiting on the host);
- device time per step by category (the port's three kernels, cuDNN
  convolutions, layout transposes, GEMM, elementwise, reductions, the
  rest);
- the heaviest kernels by device time.

Run on the card: ``python3 tools/torch_profile_step.py``.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH, IMAGE, WARMUP, STEPS, TOP = 256, 224, 3, 3, 20

#: (category, substrings of the kernel name), first match wins
CATEGORIES = [
    ("K1 ghost_bn_fwd", ("ghost_bn_fwd_kernel",)),
    ("K2 ghost_bn_bwd", ("ghost_bn_bwd_kernel",)),
    ("K3 maxpool_idx_fwd", ("maxpool_idx_kernel",)),
    ("layout transpose", ("nchwToNhwc", "nhwcToNchw", "nchw_to_nhwc",
                          "nhwc_to_nchw", "transpose")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                             "wgrad", "dgrad", "fprop", "sm90")),
    ("gemm", ("gemm", "cutlass", "cublas")),
    ("reduction", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def category(name):
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from incubator_mxnet_tpu_torch import initializer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                           learning_rate=0.1, momentum=0.9, wd=1e-4,
                           multi_precision=True, loss_scale="dynamic",
                           compute_dtype="bfloat16", device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=g, device=dev)
    y = torch.randint(0, 1000, (BATCH,), generator=g, device=dev).float()
    for _ in range(WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.time_range.elapsed_us() / 1e3 / STEPS  # ms/step
            k[1] += 1
    busy = sum(v[0] for v in kernels.values())
    cats = {}
    for name, (ms, _) in kernels.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    card = torch.cuda.get_device_name(0)
    print("card %s; batch %d, %d px, bf16; %d traced steps"
          % (card, BATCH, IMAGE, STEPS))
    print("wall %.2f ms/step, device busy %.2f ms/step (%.1f %%), "
          "idle %.1f %%" % (wall_ms, busy, 100 * busy / wall_ms,
                            100 * (1 - busy / wall_ms)))
    print("%-24s %10s %7s" % ("category", "ms/step", "share"))
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print("%-24s %10.3f %6.1f%%" % (cat, ms, 100 * ms / busy))
    print("heaviest kernels (ms/step, launches/step):")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:TOP]:
        print("  %9.3f %5d  %s" % (ms, n // STEPS, name[:110]))
    print(json.dumps({"card": card, "wall_ms": wall_ms, "busy_ms": busy,
                      "categories_ms": cats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
