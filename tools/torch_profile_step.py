#!/usr/bin/env python3
"""Where the time of the PyTorch port's train steps goes, on one card.

Builds one of ``chip_smoke.py``'s paths, runs ``WARMUP`` steps, then
traces ``STEPS`` steps with ``torch.profiler`` and prints:

- the wall time per step and the device's busy share (summed kernel
  time over wall time; the rest is the card waiting on the host);
- device time per step by category (the port's kernels, cuDNN
  convolutions, layout transposes, GEMM, elementwise, reductions, the
  rest);
- the heaviest kernels by device time.

``--model resnet`` (the default): ``resnet50_v1(ghost_bn=16)``, batch
256, 224 px, bf16 compute, f32 master weights, sgd momentum 0.9 / lr 0.1
/ wd 1e-4, dynamic loss scale, synthetic data from a seed.
``--model lm``: ``example/long_context/train_lm_torch.py``'s
``LongContextLM`` at dim 1024, 8 heads, seq 2048, batch 4, 2 layers,
vocab 256, f32 (TF32 off), its update at lr 0.01.

Run on the card: ``python3 tools/torch_profile_step.py [--model lm]``.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH, IMAGE, WARMUP, STEPS, TOP = 256, 224, 3, 3, 20
LM = dict(vocab=256, dim=1024, heads=8, n_layers=2)
LM_SEQ, LM_BATCH, LM_LR = 2048, 4, 0.01

#: (category, substrings of the kernel name), first match wins
CATEGORIES = {
    "resnet": [
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
    ],
    "lm": [
        ("K4 flash_attn_fwd", ("flash_fwd_kernel",)),
        ("K5 flash_attn_bwd_dq", ("flash_bwd_dq_kernel",)),
        ("K6 flash_attn_bwd_dkv", ("flash_bwd_dkv_kernel",)),
        ("gemm (cuBLAS, f32)", ("gemm", "cutlass", "cublas", "xmma",
                                "sm90")),
        ("reduction", ("reduce", "Reduce")),
        ("layout copy", ("copy", "transpose")),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ],
}


def category(name, model="resnet"):
    for cat, keys in CATEGORIES[model]:
        if any(k in name for k in keys):
            return cat
    return "other"


def resnet_step(dev):
    import torch

    from incubator_mxnet_tpu_torch import initializer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

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
    return (lambda: step(x, y),
            "batch %d, %d px, bf16" % (BATCH, IMAGE))


def lm_step(dev):
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert

    spec = importlib.util.spec_from_file_location(
        "train_lm_torch",
        os.path.join(ROOT, "example", "long_context", "train_lm_torch.py"))
    lmm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lmm)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    lm = lmm.LongContextLM(device=dev, **LM)
    convert.lm_params_from_jax(lm, lmm.build_params(
        rng, LM["vocab"], LM["dim"], LM["n_layers"]))
    tokens = torch.from_numpy(lmm.synthetic_tokens(
        rng, LM["vocab"], LM_BATCH, LM_SEQ)).to(dev)
    step = lmm.make_step(lm, LM_LR)
    return (lambda: step(tokens),
            "LM dim %d, %d heads, seq %d, batch %d, %d layers, f32"
            % (LM["dim"], LM["heads"], LM_SEQ, LM_BATCH, LM["n_layers"]))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet", choices=sorted(CATEGORIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    run, label = (resnet_step if args.model == "resnet" else lm_step)(dev)
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
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
        cat = category(name, args.model)
        cats[cat] = cats.get(cat, 0.0) + ms
    card = torch.cuda.get_device_name(0)
    print("card %s; %s; %d traced steps" % (card, label, STEPS))
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
