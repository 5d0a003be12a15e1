#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``incubator_mxnet_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and no network, and imports nothing of JAX.  Phases
(nothing catches a failure; any mismatch raises and the exit code is not
0):

1. print the card's name and power limit; build the kernels from
   ``incubator_mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and print the build time;
2. hold each kernel against its plain PyTorch version on the card, in
   bf16 and f32: K1/K2 (ghost BN forward/backward) at the stem, a
   56x56x256 dual exit, a 28x28x512 donated downsample exit, a 28x28x512
   downsample BN and the 7x7x2048 final exit; K3 (max pool with index)
   at the stem on tie-heavy input; K4/K5/K6 (flash attention forward,
   dQ, dK/dV) at the LM's (4, 8, 2048, 128) causal and not, a ragged
   length (Sq = Sk = 1000, D 64) and a cross length with empty rows
   (Sq 256, Sk 128, causal, D 16);
3. the ResNet path: ``resnet50_v1(ghost_bn=16)`` at batch 256, 224 px,
   bf16 compute, f32 master weights, sgd momentum 0.9 / lr 0.1 / wd
   1e-4, a dynamic loss scale, synthetic data from a seed; ``STEPS``
   steps with the launch counters set to 0 just before; every loss
   finite and exactly 53/53/1 launches per step, none of K4-K6;
3b. the LM path: ``example/long_context/train_lm_torch.py``'s
   ``LongContextLM`` at dim 1024, 8 heads, seq 2048, batch 4, 2 layers,
   vocab 256, f32 (TF32 off), ``STEPS`` steps of its update (momentum
   0.9, lr ``LM_LR``) on its synthetic tokens, with the counters set to
   0 just before; every loss finite, the last below the first, exactly 2
   launches per step of each of K4/K5/K6 and none of K1-K3;
4. time each kernel with CUDA events at the shapes the paths gave it
   (K1 and K2 summed over one step's 53 layers; K4-K6 at one layer's
   attention), beside its plain version, its bound and, where one
   PyTorch call computes the same function, that call
   (``F.max_pool2d`` for K3, ``F.scaled_dot_product_attention`` for K4,
   its backward for K5 and K6 together); plus K4 and SDPA at
   (1, 8, 8192, 128);
5. one f32 step (TF32 off) of ``resnet50_v1(ghost_bn=16)`` at batch 16,
   64 px on the card and on the CPU from the same weights and batch;
5b. one f32 step of a small LM (dim 128, 8 heads, seq 256, batch 2, 2
   layers) on the card and on the CPU from the same weights;
6. print the kernels' JSON line, the card line, and the result line.

Tolerances of phase 2 (kernel against plain version on the same inputs):
f32 outputs within 1e-4 of the reference's largest magnitude (sums in
another order), bf16 outputs within 2^-7 of it (a value computed in f32
on both sides may round one bf16 step apart), the f32 statistics and
dgamma/dbeta sums within 1e-3 of it; max pooling exact.  Flash
attention: O and the LSE of rows that see a key as above; dQ, dK and dV
within 1e-3 (f32: each sums up to 2048 products, in another order) or
2^-6 (bf16: the gradient is rounded once, from a larger f32 sum);
rows that see no key exactly 0 in O and dQ, and their LSE below -5e29
on both sides.

Phase 5b: the LM has no ReLU or max-pool ties, so its step is not
chaotic like the ResNet's; it is held to the loss within 1e-5
(relative) and every parameter after the step within 1e-4 of its
largest magnitude.

Phase 5 compares against a noise floor measured in the same run.  This
step is chaotic at random init: nudging every CPU weight by 1e-6
(relative) moves the updates of some tensors by tens of percent (the
forward amplifies the nudge block by block, and the BN backward turns
that into update noise; phase 5 prints the floor).  So the CPU step is run
twice, plain and nudged, and the card must stay within the CPU's own
noise: loss within 1e-4 of the CPU's (relative), running stats within
1e-3 of each tensor's largest magnitude (forward quantities, well
conditioned), and the per-tensor relative update differences card-vs-CPU
at most 4x the nudged-vs-CPU ones plus 1e-3, both in their median over
the 161 parameters and in their maximum (a kernel fault moves most
tensors by O(1), which the median catches).
"""
import json
import os
import subprocess
import sys
import time

STEPS = 6          # main-path steps; the first is warm-up for the timing
BATCH = 256
IMAGE = 224
SEED = 0
# the long-context LM at bench.py --mode attention's shapes
LM = dict(vocab=256, dim=1024, heads=8, n_layers=2)
LM_SEQ, LM_BATCH = 2048, 4
# the example's lr 0.05 suits its dim-128 default; at dim 1024 its update
# (momentum 0.9) diverges by the third step, in the JAX example as in the
# port, so the full-width run takes 0.01
LM_LR = 0.01
LM_SMALL = dict(vocab=256, dim=128, heads=8, n_layers=2)
FLASH = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
#: f32 operations per element: K1 (sum, square-sum, scale, shift,
#: residual add, ReLU), K2 (xhat, mask, two reductions, dX), K3 (compares)
OPS_FWD, OPS_BWD = 7, 12


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check(name, got, want, frac):
    """Raise unless ``got`` is within ``frac`` of ``want``'s largest
    magnitude (at least 1); returns the max abs error."""
    err = _max_err(got, want)
    limit = frac * max(1.0, want.float().abs().max().item())
    print("  %-44s max_abs_err %.3e  limit %.3e" % (name, err, limit),
          flush=True)
    if not err <= limit:
        raise AssertionError("%s: max abs error %g over %g" % (name, err,
                                                              limit))
    return err


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_kernels(dev, errs):
    """Phase 2."""
    import torch

    from incubator_mxnet_tpu_torch.parallel import fused_bn, maxpool_idx

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev)

    n = BATCH
    # (label, shape, act, residual, donate, dual)
    cases = [("stem", (n, 64, 112, 112), "relu", False, False, False),
             ("56x56x256 dual exit", (n, 256, 56, 56), "relu", True, False,
              True),
             ("28x28x512 donated exit", (n, 512, 28, 28), "relu", True, True,
              True),
             ("28x28x512 downsample BN", (n, 512, 28, 28), "none", False,
              False, False),
             ("7x7x2048 final exit", (n, 2048, 7, 7), "relu", True, False,
              False)]
    for dtype in (torch.bfloat16, torch.float32):
        out_frac = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        for label, shape, act, res, donate, dual in cases:
            tag = "%s %s" % (label, str(dtype).split(".")[1])
            ng = fused_bn.ghost_group(*shape, torch.finfo(dtype).bits // 8,
                                      16, res, donate, dual)
            x = (rnd(*shape) * 2 + 0.5).to(dtype)
            r = rnd(*shape).to(dtype) if res else None
            gamma = rnd(shape[1]) * 0.2 + 1
            beta = rnd(shape[1]) * 0.2
            y, m, v = fused_bn.ghost_bn_fwd(x, gamma, beta, r, 1e-5, act, ng)
            yp, mp, vp = fused_bn._gbn_fwd_plain(x, gamma, beta, r, 1e-5, act,
                                                 ng)
            errs["ghost_bn_fwd"].append(
                _check("K1 y    " + tag, y, yp, out_frac))
            _check("K1 mean " + tag, m, mp, 1e-3)
            _check("K1 var  " + tag, v, vp, 1e-3)
            del yp, mp, vp
            gy = rnd(*shape).to(dtype)
            gy2 = rnd(*shape).to(dtype) if dual else None
            ys = y if res else None
            dx, dg, db, dr = fused_bn.ghost_bn_bwd(gy, gy2, x, ys, gamma,
                                                   beta, m, v, 1e-5, act, ng)
            dxp, dgp, dbp, drp = fused_bn._gbn_bwd_plain(
                gy, gy2, x, ys, gamma, beta, m, v, 1e-5, act, ng)
            errs["ghost_bn_bwd"].append(
                _check("K2 dx   " + tag, dx, dxp, 2 * out_frac))
            _check("K2 dgam " + tag, dg, dgp, 1e-3)
            _check("K2 dbet " + tag, db, dbp, 1e-3)
            if res:
                _check("K2 dR   " + tag, dr, drp, out_frac)
            del x, r, y, gy, gy2, dx, dxp, dr, drp
        torch.cuda.empty_cache()
        x = torch.clamp_min(torch.round(rnd(n, 64, 112, 112) * 2) / 2,
                            0).to(dtype)
        cfg = ((1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
        out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
        outp, idxp = maxpool_idx._maxpool_plain(x, *cfg)
        torch.cuda.synchronize()
        ties = (idx != 0).float().mean().item()
        err = _max_err(out, outp)
        same_idx = torch.equal(idx, idxp)
        print("  K3 stem %-35s max_abs_err %.3e  index equal %s  "
              "(non-first winners %.3f)"
              % (str(dtype).split(".")[1], err, same_idx, ties), flush=True)
        if err != 0 or not same_idx:
            raise AssertionError("K3 disagrees with its plain version")
        errs["maxpool_idx_fwd"].append(err)
        del x, out, idx, outp, idxp
        torch.cuda.empty_cache()


def _flash_module():
    import importlib

    return importlib.import_module(
        "incubator_mxnet_tpu_torch.parallel.flash_attention")


def _lm_module():
    """``example/long_context/train_lm_torch.py``, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "long_context", "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_flash(dev, errs):
    """Phase 2, K4-K6."""
    import torch

    fa = _flash_module()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    bh = LM_BATCH * LM["heads"]
    d = LM["dim"] // LM["heads"]
    # (label, BH, Sq, Sk, D, causal)
    cases = [("LM causal", bh, LM_SEQ, LM_SEQ, d, True),
             ("LM dense", bh, LM_SEQ, LM_SEQ, d, False),
             ("ragged 1000 D64", 8, 1000, 1000, 64, True),
             ("cross 256/128 D16", 8, 256, 128, 16, True)]
    for dtype in (torch.bfloat16, torch.float32):
        out_frac = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        grad_frac = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-3
        for label, n, sq, sk, dd, causal in cases:
            tag = "%s %s" % (label, str(dtype).split(".")[1])
            q = torch.randn(n, sq, dd, generator=g, device=dev).to(dtype)
            k = torch.randn(n, sk, dd, generator=g, device=dev).to(dtype)
            v = torch.randn(n, sk, dd, generator=g, device=dev).to(dtype)
            do = torch.randn(n, sq, dd, generator=g, device=dev).to(dtype)
            scale = dd ** -0.5
            out, lse = fa.flash_fwd(q, k, v, scale, causal)
            outp, lsep = fa._flash_fwd_plain(q, k, v, scale, causal)
            seen = lsep > -5e29
            errs["flash_attn_fwd"].append(_check("K4 O    " + tag, out, outp,
                                                 out_frac))
            _check("K4 LSE  " + tag, lse[seen], lsep[seen], 1e-4)
            delta = (do.float() * outp.float()).sum(-1)
            dq = fa.flash_bwd_dq(q, k, v, do, lsep, delta, scale, causal)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lsep, delta, scale, causal)
            dqp, dkp, dvp = fa._flash_bwd_plain(q, k, v, do, lsep, delta,
                                                scale, causal)
            errs["flash_attn_bwd_dq"].append(_check("K5 dQ   " + tag, dq, dqp,
                                                    grad_frac))
            errs["flash_attn_bwd_dkv"].append(max(
                _check("K6 dK   " + tag, dk, dkp, grad_frac),
                _check("K6 dV   " + tag, dv, dvp, grad_frac)))
            empty = ~seen
            if not (torch.equal(seen, lse > -5e29)
                    and torch.count_nonzero(out[empty]).item() == 0
                    and torch.count_nonzero(dq[empty]).item() == 0):
                raise AssertionError("%s: rows that see no key are not 0"
                                     % tag)
            if empty.any():
                print("  %-44s %d rows see no key: O, dQ exactly 0"
                      % ("K4/K5 " + tag, int(empty.sum())), flush=True)
            del q, k, v, do, out, lse, outp, lsep, dq, dk, dv, dqp, dkp, dvp
        torch.cuda.empty_cache()


def _losses_ok(losses):
    return all(v == v and abs(v) != float("inf") for v in losses)


def run_lm_path(dev):
    """Phase 3b: returns (losses, step_ms list, counts)."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels, convert

    lmm = _lm_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    lm = lmm.LongContextLM(LM["vocab"], LM["dim"], LM["heads"],
                           LM["n_layers"], device=dev)
    convert.lm_params_from_jax(lm, lmm.build_params(
        rng, LM["vocab"], LM["dim"], LM["n_layers"]))
    tokens = torch.from_numpy(lmm.synthetic_tokens(
        rng, LM["vocab"], LM_BATCH, LM_SEQ)).to(dev)
    step = lmm.make_step(lm, LM_LR)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = _kernels.launch_counts()
    losses = [float(v) for v in losses]
    print("  losses %s  step_ms %s" % (["%.5f" % v for v in losses],
                                       ["%.1f" % t for t in step_ms]),
          flush=True)
    if not _losses_ok(losses):
        raise AssertionError("non-finite loss on the LM path: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("the LM's loss did not fall: %s" % losses)
    want = {name: 0 for name in _kernels.KERNELS}
    want.update({name: LM["n_layers"] * STEPS for name in FLASH})
    print("  launches %s (want %s)" % (counts, want), flush=True)
    if counts != want:
        raise AssertionError("launch counts %s, want %s" % (counts, want))
    return losses, step_ms, counts


def run_main_path(dev):
    """Phase 3: returns (losses, step_ms list, BN layer configs, counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels, initializer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    torch.backends.cudnn.benchmark = True
    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    step = make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                           learning_rate=0.1, momentum=0.9, wd=1e-4,
                           multi_precision=True, loss_scale="dynamic",
                           compute_dtype="bfloat16", device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=g, device=dev)
    y = torch.randint(0, 1000, (BATCH,), generator=g, device=dev).float()

    layers = []

    def record(mod, args):
        xin = args[0]
        if isinstance(mod, resnet.GhostBNReLU) and len(layers) < 53:
            layers.append((tuple(xin.shape), xin.dtype, mod._act,
                           len(args) > 1 and args[1] is not None,
                           mod._donate_residual, mod._dual_out, mod._group,
                           mod._epsilon))

    hooks = [m.register_forward_pre_hook(record) for m in net.modules()
             if isinstance(m, resnet.GhostBNReLU)]
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for i in range(STEPS):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == 0:
            for h in hooks:
                h.remove()
    counts = _kernels.launch_counts()
    losses = [float(v) for v in losses]
    print("  losses %s  skipped %d  loss scale %g  step_ms %s"
          % (["%.5f" % v for v in losses], step.skipped_steps,
             step.loss_scale, ["%.1f" % t for t in step_ms]), flush=True)
    if not _losses_ok(losses):
        raise AssertionError("non-finite loss on the main path: %s" % losses)
    want = {name: 0 for name in _kernels.KERNELS}
    want.update({"ghost_bn_fwd": 53 * STEPS, "ghost_bn_bwd": 53 * STEPS,
                 "maxpool_idx_fwd": STEPS})
    print("  launches %s (want %s)" % (counts, want), flush=True)
    if counts != want:
        raise AssertionError("launch counts %s, want %s" % (counts, want))
    if len(layers) != 53:
        raise AssertionError("recorded %d ghost-BN layers" % len(layers))
    return losses, step_ms, layers, counts
    # the net, the step and their buffers go out of scope here


def time_kernels(dev, layers):
    """Phase 4: per-kernel times summed over one step's launches."""
    import torch
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.parallel import fused_bn, maxpool_idx

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    distinct = {}
    for cfg in layers:
        distinct[cfg] = distinct.get(cfg, 0) + 1
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
           for k in ("ghost_bn_fwd", "ghost_bn_bwd")}
    for (shape, dtype, act, res, donate, dual, group, eps), k in \
            distinct.items():
        n, c, h, w = shape
        isz = torch.finfo(dtype).bits // 8
        ng = fused_bn.ghost_group(n, c, h, w, isz, group, res, donate and res,
                                  dual)
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        r = torch.randn(*shape, generator=g, device=dev).to(dtype) \
            if res else None
        gamma = torch.ones(c, device=dev)
        beta = torch.zeros(c, device=dev)
        y, m, v = fused_bn.ghost_bn_fwd(x, gamma, beta, r, eps, act, ng)
        gy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        gy2 = torch.randn(*shape, generator=g, device=dev).to(dtype) \
            if dual else None
        ys = y if res else None
        numel = x.numel()
        small = (2 * c + 2 * (n // ng) * c) * 4
        f = tot["ghost_bn_fwd"]
        f["ms"] += k * _time_ms(lambda: fused_bn.ghost_bn_fwd(
            x, gamma, beta, r, eps, act, ng), 10)
        f["plain_ms"] += k * _time_ms(lambda: fused_bn._gbn_fwd_plain(
            x, gamma, beta, r, eps, act, ng), 3)
        f["bytes"] += k * (numel * isz * (2 + res) + small)
        f["ops"] += k * numel * OPS_FWD
        b = tot["ghost_bn_bwd"]
        b["ms"] += k * _time_ms(lambda: fused_bn.ghost_bn_bwd(
            gy, gy2, x, ys, gamma, beta, m, v, eps, act, ng), 10)
        b["plain_ms"] += k * _time_ms(lambda: fused_bn._gbn_bwd_plain(
            gy, gy2, x, ys, gamma, beta, m, v, eps, act, ng), 3)
        b["bytes"] += k * (numel * isz * (3 + dual + 2 * res) + small)
        b["ops"] += k * numel * OPS_BWD
        print("  %-22s %-8s act=%-4s res=%d donate=%d dual=%d group=%d x%d"
              % (shape, str(dtype).split(".")[1], act, res, donate, dual, ng,
                 k), flush=True)
        del x, r, y, gy, gy2, ys, m, v
    torch.cuda.empty_cache()
    rows = {}
    for name, t in tot.items():
        byte_ms = t["bytes"] / PEAK_BYTES * 1e3
        op_ms = t["ops"] / PEAK_F32 * 1e3
        rows[name] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                      "bound_ms": max(byte_ms, op_ms),
                      "bound_by": "bytes" if byte_ms >= op_ms
                      else "operations", "library_ms": None}
    # K3 at the stem: (256, 64, 112, 112) bf16 -> (256, 64, 56, 56)
    x = torch.clamp_min(torch.randn(BATCH, 64, IMAGE // 2, IMAGE // 2,
                                    generator=g, device=dev), 0)
    x = x.to(torch.bfloat16)
    cfg = ((1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
    out_numel = BATCH * 64 * (IMAGE // 4) ** 2
    byte_ms = (x.numel() * 2 + out_numel * (2 + 1)) / PEAK_BYTES * 1e3
    op_ms = out_numel * 9 / PEAK_F32 * 1e3
    rows["maxpool_idx_fwd"] = {
        "ms": _time_ms(lambda: maxpool_idx.maxpool_with_index(x, *cfg), 20),
        "plain_ms": _time_ms(lambda: maxpool_idx._maxpool_plain(x, *cfg), 3),
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": _time_ms(lambda: F.max_pool2d(
            x, 3, 2, 1, return_indices=True), 20)}
    del x
    torch.cuda.empty_cache()
    return rows


def _causal_pairs(sq, sk):
    """Visible (i, j) pairs of one head under the right-aligned mask."""
    return sum(min(max(i + sk - sq + 1, 0), sk) for i in range(sq))


def _bound(nbytes, ops):
    byte_ms = nbytes / PEAK_BYTES * 1e3
    op_ms = ops / PEAK_F32 * 1e3
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def time_flash(dev):
    """Phase 4, K4-K6 at one LM layer's attention: (4, 8, 2048, 128),
    causal, f32.  Bounds count the products only (2 FLOP per multiply-add
    over the visible pairs: S and PV for K4; S, dP, dQ for K5; S, dP, dV,
    dK for K6) and each input read, each output written once."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, h, s = LM_BATCH, LM["heads"], LM_SEQ
    d = LM["dim"] // h
    q, k, v, do = (torch.randn(b * h, s, d, generator=g, device=dev)
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (do * out).sum(-1)
    pairs = b * h * _causal_pairs(s, s)
    mat = b * h * s * d * 4                    # one (BH, S, D) f32 tensor
    row = b * h * s * 4                        # one (BH, S) f32 vector
    rows = {
        "flash_attn_fwd": dict(
            ms=_time_ms(lambda: fa.flash_fwd(q, k, v, scale, True), 10),
            plain_ms=_time_ms(lambda: fa._flash_fwd_plain(q, k, v, scale,
                                                          True), 3),
            **_bound(4 * mat + row, 4 * d * pairs)),
        "flash_attn_bwd_dq": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                scale, True), 10),
            plain_ms=_time_ms(lambda: fa._flash_bwd_dq_plain(
                q, k, v, do, lse, delta, scale, True), 3),
            **_bound(5 * mat + 2 * row, 6 * d * pairs)),
        "flash_attn_bwd_dkv": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                 scale, True), 10),
            plain_ms=_time_ms(lambda: fa._flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, scale, True), 3),
            **_bound(6 * mat + 2 * row, 8 * d * pairs)),
    }
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    rows["flash_attn_fwd"]["library_ms"] = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        10)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do4, retain_graph=True), 10)
    # one call computes dQ, dK and dV: the same time stands in both rows
    rows["flash_attn_bwd_dq"]["library_ms"] = lib_bwd
    rows["flash_attn_bwd_dkv"]["library_ms"] = lib_bwd
    err = _max_err(out.view(b, h, s, d), lib_out.detach())
    print("  SDPA forward against K4: max abs diff %.3e" % err, flush=True)
    del q, k, v, do, out, lse, delta, q4, k4, v4, do4, leaves, lib_out
    torch.cuda.empty_cache()

    # the long row: one sequence of 8192, forward only
    sl = 8192
    ql, kl, vl = (torch.randn(h, sl, d, generator=g, device=dev)
                  for _ in range(3))
    long_ms = _time_ms(lambda: fa.flash_fwd(ql, kl, vl, scale, True), 5)
    q4, k4, v4 = (t.view(1, h, sl, d) for t in (ql, kl, vl))
    long_lib = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 5)
    long_bound = _bound(4 * h * sl * d * 4 + h * sl * 4,
                        4 * d * h * _causal_pairs(sl, sl))
    print("  K4 at (1, 8, 8192, 128) causal f32: ms %.4f  library_ms %.4f  "
          "bound_ms %.4f (%s)" % (long_ms, long_lib, long_bound["bound_ms"],
                                  long_bound["bound_by"]), flush=True)
    del ql, kl, vl, q4, k4, v4
    torch.cuda.empty_cache()
    return rows


def lm_card_vs_cpu(dev):
    """Phase 5b: one f32 step of a small LM on the card and on the CPU from
    the same numpy weights and tokens."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert

    lmm = _lm_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    start = lmm.build_params(rng, LM_SMALL["vocab"], LM_SMALL["dim"],
                             LM_SMALL["n_layers"])
    tokens = lmm.synthetic_tokens(rng, LM_SMALL["vocab"], 2, 256)
    losses, after = {}, {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        lm = lmm.LongContextLM(device=d, **LM_SMALL)
        convert.lm_params_from_jax(lm, start)
        losses[where] = lmm.make_step(lm, 0.05)(
            torch.from_numpy(tokens).to(d)).item()
        after[where] = dict(lm.named_parameters())
    worst = 0.0
    for name, p in after["cpu"].items():
        ref = p.detach()
        err = (after["cuda"][name].detach().cpu() - ref).abs().max().item()
        worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    lrel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print("  loss card %.7f cpu %.7f  rel diff %.3e (limit 1e-5); params "
          "after the step: max diff %.3e of each tensor's largest magnitude "
          "(limit 1e-4)" % (losses["cuda"], losses["cpu"], lrel, worst),
          flush=True)
    if not (lrel <= 1e-5 and worst <= 1e-4):
        raise AssertionError("card and CPU LM steps disagree")


def card_vs_cpu(dev):
    """Phase 5: one small f32 step on the card and on the CPU (plain and
    with every weight nudged by 1e-6, the CPU's own noise floor)."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert, initializer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    where = {"cuda": "cuda", "cpu": "cpu", "cpu_nudged": "cpu"}
    runs = {d: resnet.resnet50_v1(classes=1000, ghost_bn=16, device=w)
            for d, w in where.items()}
    initializer.initialize(runs["cuda"], initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    start = convert.params_to_numpy(runs["cuda"])
    for d in ("cpu", "cpu_nudged"):
        convert.params_from_jax(runs[d], start)
    nudge = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for p in runs["cpu_nudged"].parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=nudge))
    names = [n for n, _ in convert.ordered_tensors(runs["cpu"])]
    is_param = {n for n, _ in runs["cpu"].named_parameters()}
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.normal(size=(16, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, 16).astype(np.float32))
    losses, after = {}, {}
    for d, net in runs.items():
        before = convert.params_to_numpy(net)
        step = make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                               learning_rate=0.1, momentum=0.9, wd=1e-4,
                               multi_precision=True, loss_scale="dynamic",
                               device=where[d])
        losses[d] = step(x, y).item()
        if step.skipped_steps:
            raise AssertionError("the %s step was skipped" % d)
        after[d] = [(a, a - b) for a, b in
                    zip(convert.params_to_numpy(net), before)]

    def rel_update(d):
        out = []
        for n, (_, upd), (_, ref) in zip(names, after[d], after["cpu"]):
            if n in is_param:
                out.append(float(np.abs(upd - ref).max())
                           / max(float(np.abs(ref).max()), 1e-30))
        return np.array(out)

    card, noise = rel_update("cuda"), rel_update("cpu_nudged")
    stats = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                for n, (a, _), (b, _) in zip(names, after["cuda"], after["cpu"])
                if n not in is_param)
    lrel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print("  loss card %.6f cpu %.6f  rel diff %.3e (limit 1e-4)"
          % (losses["cuda"], losses["cpu"], lrel), flush=True)
    print("  running stats max rel diff %.3e (limit 1e-3)" % stats, flush=True)
    print("  update rel diff card-vs-cpu median %.3e max %.3e;  noise floor "
          "(cpu nudged 1e-6) median %.3e max %.3e  (limit 4x floor + 1e-3)"
          % (np.median(card), card.max(), np.median(noise), noise.max()),
          flush=True)
    if not (lrel <= 1e-4 and stats <= 1e-3
            and np.median(card) <= 4 * np.median(noise) + 1e-3
            and card.max() <= 4 * noise.max() + 1e-3):
        raise AssertionError("card and CPU steps disagree")
    torch.backends.cudnn.allow_tf32 = True


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch import _kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = _card_line()
    print("[1] card: %s" % card, flush=True)
    build_s = _kernels.build()
    print("[1] kernels built in %.1f s" % build_s, flush=True)

    print("[2] kernels against their plain versions", flush=True)
    errs = {name: [] for name in _kernels.KERNELS}
    check_kernels(dev, errs)
    check_flash(dev, errs)

    print("[3] ResNet path: resnet50_v1(ghost_bn=16) batch %d, %d px, bf16, "
          "%d steps" % (BATCH, IMAGE, STEPS), flush=True)
    losses, step_ms, layers, counts = run_main_path(dev)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    print("[3] step_ms %.2f (median of steps 2-%d)  %.1f img/s  on %s"
          % (steady, STEPS, BATCH / steady * 1e3, card), flush=True)
    torch.cuda.empty_cache()

    print("[3b] LM path: LongContextLM dim %d, %d heads, seq %d, batch %d, "
          "%d layers, f32, %d steps" % (LM["dim"], LM["heads"], LM_SEQ,
                                        LM_BATCH, LM["n_layers"], STEPS),
          flush=True)
    _, lm_ms, lm_counts = run_lm_path(dev)
    counts.update({name: lm_counts[name] for name in FLASH})
    lm_steady = sorted(lm_ms[1:])[len(lm_ms[1:]) // 2]
    print("[3b] lm_step_ms %.2f (median of steps 2-%d)  %.1f tokens/s  on %s"
          % (lm_steady, STEPS, LM_BATCH * LM_SEQ / lm_steady * 1e3, card),
          flush=True)
    torch.cuda.empty_cache()

    print("[4] kernel times (CUDA events, K1/K2 summed over one step's 53 "
          "layers, K4-K6 one layer's attention)", flush=True)
    rows = time_kernels(dev, layers)
    rows.update(time_flash(dev))
    for name, row in rows.items():
        print("  %-18s ms %.4f  plain_ms %.4f  bound_ms %.4f (%s)  "
              "library_ms %s" % (name, row["ms"], row["plain_ms"],
                                 row["bound_ms"], row["bound_by"],
                                 row["library_ms"]), flush=True)

    print("[5] one f32 step at batch 16, 64 px: card against CPU", flush=True)
    card_vs_cpu(dev)
    print("[5b] one f32 step of the LM at dim 128, seq 256: card against CPU",
          flush=True)
    lm_card_vs_cpu(dev)

    here = os.path.dirname(os.path.abspath(__file__))
    meta = {
        "ghost_bn_fwd": ("incubator_mxnet_tpu_torch/csrc/ghost_bn.cu",
                         "incubator_mxnet_tpu/parallel/fused_bn.py:537"),
        "ghost_bn_bwd": ("incubator_mxnet_tpu_torch/csrc/ghost_bn.cu",
                         "incubator_mxnet_tpu/parallel/fused_bn.py:577"),
        "maxpool_idx_fwd": ("incubator_mxnet_tpu_torch/csrc/maxpool_idx.cu",
                            "incubator_mxnet_tpu/parallel/maxpool_idx.py:145"),
        "flash_attn_fwd": ("incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
                           "incubator_mxnet_tpu/parallel/flash_attention.py:139"),
        "flash_attn_bwd_dq": (
            "incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
            "incubator_mxnet_tpu/parallel/flash_attention.py:261"),
        "flash_attn_bwd_dkv": (
            "incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
            "incubator_mxnet_tpu/parallel/flash_attention.py:279"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        if not os.path.exists(os.path.join(here, source)):
            raise AssertionError("missing source %s" % source)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=max(errs[name]), **rows[name]))
    print("[6] done in %.1f s" % (time.perf_counter() - t_start), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
