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
   length (Sq = Sk = 1000, D 64), a cross length with empty rows (Sq 256,
   Sk 128, causal, D 16), head dims 20 and 4 (zero-padded to 24 and 8)
   and b*h = 70000 at S 16; each case's launches of K4-K6 counted; head
   dim 256, which no kernel takes, refused with ValueError and no launch;
2c. K7 (``bn_copy``, the copy over ghost-BN blocks that K1 and K2 are
   read against) bit-exact against ``clone()`` at the 9 ResNet-50 BN
   shapes (batch 256, bf16) and, in bf16 and f32, at C 3 / HW 5 and C 64
   / HW 49, with x on and off y's 16-byte grid; the rtc kernels
   compiled by NVRTC from ``incubator_mxnet_tpu_torch/csrc/rtc`` (their
   compile ms printed): R1 ``scale_kernel`` exact against ``2x + 1`` at
   (4, 8, 2048, 128) f32, at n 1, 3, 5 and 1000003, and on views 1-3
   floats off the 16-byte grid, R2 ``mm_kernel`` within 1e-4 of max |a @ b| at
   (8192, 1024) @ (1024, 1024) and a ragged (1000, 300) @ (300, 129);
   a missing export or kernel raises ValueError and a float64 launch
   TypeError;
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
3c. the imperative path: one causal attention layer of the LM at its
   width written with ``nd`` and ``autograd`` alone (x (4, 2048, 1024)
   from numpy seed 1; Wq, Wk, Wv, Wo (1024, 1024) from
   ``nd.random.uniform`` after ``nd.random.seed(0)`` on ``mx.gpu(0)``,
   with ``attach_grad``): ``nd.dot``, reshape/transpose to heads,
   ``nd.contrib.flash_attention(causal=True)``, back, ``nd.dot`` with Wo,
   ``(y * y).mean()``, ``backward``; ``STEPS`` steps with the counters at
   0 just before, then R1 on y and R2 on the output projection through
   rtc; exactly 1/1/1 launches of K4/K5/K6 a step, R1 and R2 once, none
   of K1-K3 or K7; loss and the four weight gradients within 1e-4
   (relative) of the same layer in plain torch autograd (dense
   ``attention_reference``); ``nd_step_ms`` the median of steps 2-6;
4. time each kernel with CUDA events at the shapes the paths gave it
   (K1 and K2 summed over one step's 53 layers; K4-K6 at one layer's
   attention), beside its plain version, its bound and, where one
   PyTorch call computes the same function, that call
   (``F.max_pool2d`` for K3, ``F.scaled_dot_product_attention`` for K4,
   its backward for K5 and K6 together); plus K4 and SDPA at
   (1, 8, 8192, 128).  Bounds are the larger of bytes over 3.35 TB/s and
   operations over the f32 CUDA cores' 67 TFLOP/s; K4-K6 also carry
   ``tc_bound_ms``, their 3xTF32 bound on the tensor cores (three TF32
   passes of every product at 495 TFLOP/s), and ``ms_over_library``
   (K5 and K6 each over SDPA's whole backward; a line gives K5 + K6 over
   it);
4c. K7 at the 9 BN shapes (with its channels a block, ``kc``) beside
   ``Tensor.copy_``, K1 and K2 (through ``tools/bn_kernel_bench_torch.py``),
   with K1 and K2 as a share of K7's time (what they cost beyond the
   walk over contiguous runs that K7 copies with), and R1 beside
   ``torch.add(1, x, alpha=2)``: all on one clock, the profiler's device
   time a launch with the L2 flushed (256 MB written) before every
   launch; the K7 and R1 rows carry ``ms_over_library``.  R2 beside its
   bound and ``torch.matmul`` (TF32 off), both by the profiler's device
   time (unflushed), with ``tc_bound_ms`` and ``ms_over_library`` as K4;
   K7's launches are those of this sweep;
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
# the nd path: one attention layer of the LM at its width (phase 3c)
ND_TOL = 1e-4
RTC = ("scale_kernel", "mm_kernel")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense TF32 FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
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

    from incubator_mxnet_tpu_torch import _kernels

    fa = _flash_module()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    bh = LM_BATCH * LM["heads"]
    d = LM["dim"] // LM["heads"]
    # (label, BH, Sq, Sk, D, causal)
    cases = [("LM causal", bh, LM_SEQ, LM_SEQ, d, True),
             ("LM dense", bh, LM_SEQ, LM_SEQ, d, False),
             ("ragged 1000 D64", 8, 1000, 1000, 64, True),
             ("cross 256/128 D16", 8, 256, 128, 16, True),
             # head dims the kernels take zero-padded to a multiple of 8,
             # b*h over 65535
             ("D20 padded", 8, 300, 300, 20, True),
             ("D4 padded 200/136", 8, 200, 136, 4, True),
             ("b*h 70000 S16 D32", 70000, 16, 16, 32, True)]
    for dtype in (torch.bfloat16, torch.float32):
        out_frac = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        grad_frac = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-3
        for label, n, sq, sk, dd, causal in cases:
            tag = "%s %s" % (label, str(dtype).split(".")[1])
            before = _kernels.launch_counts()
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
            got = {name: _kernels.launch_counts()[name] - before[name]
                   for name in FLASH}
            want = {name: 1 for name in FLASH}
            if got != want:
                raise AssertionError("%s: launches %s, want %s"
                                     % (tag, got, want))
            del q, k, v, do, out, lse, outp, lsep, dq, dk, dv, dqp, dkp, dvp
        torch.cuda.empty_cache()
    # D > 128: no form of K4-K6 takes it, and a card tensor never falls
    # back to the plain version
    before = _kernels.launch_counts()
    big = torch.zeros(8, 512, 256, device=dev)
    for fn, args in ((fa.flash_fwd, (big, big, big, 0.0625, True)),
                     (fa.flash_attention, (big[None], big[None], big[None]))):
        try:
            fn(*args)
        except ValueError as e:
            print("  %-44s refused: %s" % ("D256 " + fn.__name__, e),
                  flush=True)
        else:
            raise AssertionError("D256 %s was not refused" % fn.__name__)
    if _kernels.launch_counts() != before:
        raise AssertionError("D256: a kernel launched before the refusal")


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
    want = {name: 0 for name in _kernels.launch_counts()}
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
    want = {name: 0 for name in _kernels.launch_counts()}
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


def _bound(nbytes, ops, peak=PEAK_F32):
    """The least time for ``nbytes`` of traffic and ``ops`` operations at
    ``peak`` operations a second."""
    byte_ms = nbytes / PEAK_BYTES * 1e3
    op_ms = ops / peak * 1e3
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def _tensor_core_row(row, nbytes, ops):
    """Add to a 3xTF32 kernel's row its bound on the tensor cores (three
    TF32 passes of every product) and its time over the library call's."""
    row["tc_bound_ms"] = _bound(nbytes, 3 * ops, PEAK_TF32)["bound_ms"]
    row["ms_over_library"] = row["ms"] / row["library_ms"]


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
    _tensor_core_row(rows["flash_attn_fwd"], 4 * mat + row, 4 * d * pairs)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do4, retain_graph=True), 10)
    # one call computes dQ, dK and dV: the same time stands in both rows,
    # and beside K5 + K6 together
    rows["flash_attn_bwd_dq"]["library_ms"] = lib_bwd
    rows["flash_attn_bwd_dkv"]["library_ms"] = lib_bwd
    _tensor_core_row(rows["flash_attn_bwd_dq"], 5 * mat + 2 * row,
                     6 * d * pairs)
    _tensor_core_row(rows["flash_attn_bwd_dkv"], 6 * mat + 2 * row,
                     8 * d * pairs)
    pair_ms = (rows["flash_attn_bwd_dq"]["ms"]
               + rows["flash_attn_bwd_dkv"]["ms"])
    print("  K5 + K6 at (4, 8, 2048, 128) causal f32: ms %.4f  SDPA backward "
          "%.4f  (K5 + K6)/SDPA backward %.3f  tc_bound_ms %.4f" % (
              pair_ms, lib_bwd, pair_ms / lib_bwd,
              rows["flash_attn_bwd_dq"]["tc_bound_ms"]
              + rows["flash_attn_bwd_dkv"]["tc_bound_ms"]), flush=True)
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
    long_row = dict(ms=long_ms, library_ms=long_lib,
                    **_bound(4 * h * sl * d * 4 + h * sl * 4,
                             4 * d * h * _causal_pairs(sl, sl)))
    _tensor_core_row(long_row, 4 * h * sl * d * 4 + h * sl * 4,
                     4 * d * h * _causal_pairs(sl, sl))
    print("  K4 at (1, 8, 8192, 128) causal f32: ms %.4f  library_ms %.4f  "
          "ms/library %.3f  bound_ms %.4f (%s)  tc_bound_ms %.4f"
          % (long_ms, long_lib, long_row["ms_over_library"],
             long_row["bound_ms"], long_row["bound_by"],
             long_row["tc_bound_ms"]), flush=True)
    del ql, kl, vl, q4, k4, v4
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 2c, 3c, 4c: K7, the rtc kernels R1/R2 and the imperative nd path
# ---------------------------------------------------------------------------


def _device_ms(fn, reps, name=None):
    """Mean device time in ms a call of ``fn`` (over ``reps`` calls) of the
    kernel ``name``, or of every kernel it launches, from torch.profiler's
    CUDA trace (as ``tools/torch_profile_step.py`` reads it): the kernels'
    own time, also where the host launches them more slowly than the card
    runs them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and name in (None, ev.name)]
    if len(times) != reps and (name is not None or len(times) < reps):
        raise AssertionError("the profiler saw %d launches of %s, want %d"
                             % (len(times), name or "kernels", reps))
    return sum(times) / reps


def _bench_tool():
    """``tools/bn_kernel_bench_torch.py``, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "bn_kernel_bench_torch.py")
    spec = importlib.util.spec_from_file_location("bn_kernel_bench_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_err(got, want):
    """Max abs error over the reference's largest magnitude."""
    return _max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def check_copy_and_rtc(dev, errs):
    """Phase 2c: K7 bit-exact against ``clone()`` at the 9 BN shapes; R1
    exact and R2 within ND_TOL (relative) of their plain versions; the
    rtc refusals.  Returns ``{name: CudaKernel}`` of R1 and R2."""
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.parallel import fused_bn

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs["bn_copy"] = []
    for shape in _bench_tool().SHAPES:
        ng = fused_bn.ghost_group(*shape, 2, 16)
        x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
        y = fused_bn.bn_copy(x, ng)
        same = torch.equal(y.view(torch.int16), x.clone().view(torch.int16))
        print("  K7 %-22s group %-2d bit-exact against clone(): %s"
              % (shape, ng, same), flush=True)
        if not same:
            raise AssertionError("K7 differs from clone() at %s" % (shape,))
        errs["bn_copy"].append(_max_err(y, x))
        del x, y
    # runs that are not whole 16-byte vectors (scalar head and tail), and
    # an x off the 16-byte grid of y (every element scalar)
    for shape, ng, offset in (((48, 3, 1, 5), 16, 0), ((256, 64, 7, 7), 16, 0),
                              ((48, 3, 1, 5), 16, 1), ((64, 64, 7, 7), 16, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            numel = shape[0] * shape[1] * shape[2] * shape[3]
            x = torch.randn(numel + offset, generator=g, device=dev) \
                .to(dtype)[offset:].view(shape)
            y = fused_bn.bn_copy(x, ng)
            same = torch.equal(y.view(-1), x.clone().view(-1))
            print("  K7 %-22s %-8s x offset %d: bit-exact: %s"
                  % (shape, str(dtype).split(".")[1], offset, same),
                  flush=True)
            if not same:
                raise AssertionError("K7 differs from clone() at %s %s"
                                     % (shape, dtype))
    torch.cuda.empty_cache()

    kernels = {}
    for name in RTC:
        mod = rtc.CudaModule(rtc.user_source(name), exports=[name])
        kernels[name] = mod.get_kernel(name, rtc.USER_KERNELS[name])
        print("  %-12s NVRTC compile %.1f ms (%s)" % (name, mod.compile_ms,
                                                      rtc.USER_KERNELS[name]),
              flush=True)
    ctx = mx.gpu(dev.index or 0)
    d = LM["dim"] // LM["heads"]
    x = mx.nd.NDArray(torch.randn(LM_BATCH, LM["heads"], LM_SEQ, d,
                                  generator=g, device=dev))
    y = rtc.launch_scale(kernels["scale_kernel"], x, ctx)
    want = rtc.scale_plain(x._data)
    err = _max_err(y._data, want)
    print("  R1 scale_kernel (%d, %d, %d, %d) f32: max_abs_err %.3e (exact "
          "required)" % (LM_BATCH, LM["heads"], LM_SEQ, d, err), flush=True)
    if not torch.equal(y._data, want):
        raise AssertionError("R1 is not exact")
    errs["scale_kernel"] = [err]
    # ragged n; x and y views 1-3 floats off the 16-byte grid, together
    # (a scalar head, then float4) and x alone (every element scalar)
    r1 = kernels["scale_kernel"]
    for n in (1, 3, 5, 1000003):
        xs = mx.nd.NDArray(torch.randn(n, generator=g, device=dev))
        ok = torch.equal(rtc.launch_scale(r1, xs, ctx)._data,
                         rtc.scale_plain(xs._data))
        for off in (1, 2, 3):
            xb = torch.randn(n + 4, generator=g, device=dev)
            yb = torch.empty(n + 4, device=dev)
            xv = mx.nd.NDArray(xb[off:off + n])
            r1.launch([xv, mx.nd.NDArray(yb[off:off + n]), n], ctx,
                      rtc.scale_grid(n, ctx), (rtc.SCALE_THREADS, 1, 1))
            ok = ok and torch.equal(yb[off:off + n], rtc.scale_plain(xv._data))
            ok = ok and torch.equal(rtc.launch_scale(r1, xv, ctx)._data,
                                    rtc.scale_plain(xv._data))
        print("  R1 n %-8d offsets 0-3 (x and y, x alone) exact: %s"
              % (n, ok), flush=True)
        if not ok:
            raise AssertionError("R1 is not exact at n %d" % n)
    errs["mm_kernel"] = []
    for m, k, n in ((LM_BATCH * LM_SEQ, LM["dim"], LM["dim"]),
                    (1000, 300, 129)):
        a = mx.nd.NDArray(torch.randn(m, k, generator=g, device=dev))
        b = mx.nd.NDArray(torch.randn(k, n, generator=g, device=dev))
        c = rtc.launch_mm(kernels["mm_kernel"], a, b, ctx)
        want = rtc.mm_plain(a._data, b._data)
        rel = _rel_err(c._data, want)
        print("  R2 mm_kernel (%d, %d) @ (%d, %d) f32: max_abs_err %.3e, "
              "%.3e of max |a @ b| (limit %.0e)"
              % (m, k, k, n, _max_err(c._data, want), rel, ND_TOL),
              flush=True)
        if not rel <= ND_TOL:
            raise AssertionError("R2 disagrees with a @ b")
        errs["mm_kernel"].append(_max_err(c._data, want))
    # the refusals: a missing export or kernel, a wrong dtype
    for build in (lambda: rtc.CudaModule(rtc.user_source("scale_kernel"),
                                         exports=["nope"]),
                  lambda: rtc.CudaModule(
                      rtc.user_source("scale_kernel")).get_kernel(
                          "missing", "const float *x")):
        try:
            build()
        except ValueError as e:
            print("  refused as it should: ValueError(%s)" % e, flush=True)
        else:
            raise AssertionError("a missing export or kernel did not raise")
    try:
        kernels["scale_kernel"].launch([x.astype("float64"), y, x.size], ctx,
                                       (1, 1, 1), (256, 1, 1))
    except TypeError as e:
        print("  refused as it should: TypeError(%s)" % e, flush=True)
    else:
        raise AssertionError("a float64 launch of scale_kernel did not raise")
    del x, y, a, b, c, want
    torch.cuda.empty_cache()
    return kernels


def nd_attention_layer(mx, x, w, heads):
    """One causal attention layer of the LM, with ``nd`` and ``autograd``
    alone: ``(loss, y, a)`` after ``loss.backward()``, where ``a`` is the
    attention output before the output projection ``y = a @ wo``."""
    nd = mx.nd
    b, s, dim = x.shape
    dh = dim // heads

    def heads_first(t):
        return t.reshape((b, s, heads, dh)).transpose((0, 2, 1, 3))

    with mx.autograd.record():
        q, k, v = (heads_first(nd.dot(x, w[n])) for n in ("wq", "wk", "wv"))
        o = nd.contrib.flash_attention(q, k, v, causal=True)
        a = o.transpose((0, 2, 1, 3)).reshape((b, s, dim))
        y = nd.dot(a, w["wo"])
        loss = (y * y).mean()
    loss.backward()
    return loss, y, a


def run_nd_path(dev, kernels):
    """Phase 3c: the nd layer at the LM's width, STEPS times, then R1 on y
    and R2 on the output projection; returns (step_ms list, counts)."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, rtc
    from incubator_mxnet_tpu_torch.parallel.ring_attention import \
        attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    nd = mx.nd
    ctx = mx.gpu(dev.index or 0)
    dim, heads = LM["dim"], LM["heads"]
    nd.random.seed(0)
    bound = dim ** -0.5
    w = {n: nd.random.uniform(-bound, bound, shape=(dim, dim), ctx=ctx)
         for n in ("wq", "wk", "wv", "wo")}
    for p in w.values():
        p.attach_grad()
    x = nd.array(np.random.RandomState(1).standard_normal(
        (LM_BATCH, LM_SEQ, dim)).astype(np.float32), ctx=ctx)
    step_ms = []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for k in kernels.values():
        k.launches = 0
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss, y, a = nd_attention_layer(mx, x, w, heads)
        nd.waitall()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    r1 = rtc.launch_scale(kernels["scale_kernel"], y, ctx)
    a2 = a.reshape((LM_BATCH * LM_SEQ, dim))
    r2 = rtc.launch_mm(kernels["mm_kernel"], a2, w["wo"], ctx)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    counts.update({n: k.launches for n, k in kernels.items()})
    want = {n: 0 for n in _kernels.launch_counts()}
    want.update({n: STEPS for n in FLASH})
    want.update({n: 1 for n in RTC})
    print("  launches %s (want %s)" % (counts, want), flush=True)
    if counts != want:
        raise AssertionError("launch counts %s, want %s" % (counts, want))

    # the same layer in plain torch autograd, dense attention
    wt = {n: p._data.detach().clone().requires_grad_() for n, p in w.items()}
    xt = x._data
    b, s = LM_BATCH, LM_SEQ

    def heads_first(t):
        return t.view(b, s, heads, dim // heads).transpose(1, 2)

    q, k_, v = (heads_first(xt @ wt[n]) for n in ("wq", "wk", "wv"))
    ref_a = attention_reference(q, k_, v, causal=True).transpose(1, 2) \
        .reshape(b, s, dim)
    ref_y = ref_a @ wt["wo"]
    ref_loss = (ref_y * ref_y).mean()
    ref_grads = torch.autograd.grad(ref_loss, list(wt.values()))
    lrel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    grel = {n: _rel_err(w[n].grad._data, gr)
            for n, gr in zip(wt, ref_grads)}
    print("  loss nd %.7f torch %.7f rel diff %.3e; gradients %s of each "
          "reference's largest magnitude (tolerance %.0e)"
          % (loss.item(), ref_loss.item(), lrel,
             {n: "%.3e" % e for n, e in grel.items()}, ND_TOL), flush=True)
    if not (lrel <= ND_TOL and max(grel.values()) <= ND_TOL):
        raise AssertionError("the nd layer disagrees with plain torch")
    with torch.no_grad():
        r1_ok = torch.equal(r1._data, rtc.scale_plain(y._data))
        r2_rel = _rel_err(r2._data, y._data.reshape(b * s, dim))
    print("  R1 on y exact: %s; R2 projection against y: %.3e (tolerance "
          "%.0e)" % (r1_ok, r2_rel, ND_TOL), flush=True)
    if not (r1_ok and r2_rel <= ND_TOL):
        raise AssertionError("R1 or R2 disagrees on the nd path")
    del w, x, loss, y, a, a2, r1, r2, wt, ref_a, ref_y, ref_loss, ref_grads
    torch.cuda.empty_cache()
    return step_ms, counts


def time_nd_kernels(dev, kernels):
    """Phase 4c: K7 at the 9 BN shapes beside ``copy_``, K1 and K2, and R1
    beside ``torch.add``, each by the profiler's device time with the L2
    flushed before every launch (``tools/bn_kernel_bench_torch.py``'s
    ``flushed_device_ms``); R2 beside its bound and ``torch.matmul``.
    Returns (rows, K7's launches)."""
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, rtc
    from incubator_mxnet_tpu_torch.parallel import fused_bn

    torch.backends.cuda.matmul.allow_tf32 = False
    tool = _bench_tool()

    def flushed(fn, name=None, reps=10):
        return tool.flushed_device_ms(fn, reps, dev, name)

    rows = {}
    _kernels.reset_launch_counts()
    print("  L2 flushed (%d MB written) before every timed launch; device "
          "ms a launch" % (tool.FLUSH_BYTES >> 20), flush=True)
    print("  %-20s %3s %9s %9s %8s %9s %9s %9s %7s %7s" % (
        "shape (bf16)", "kc", "K7 ms", "copy_ ms", "K7/copy_", "bound ms",
        "K1 ms", "K2 ms", "K1/K7", "K2/K7"), flush=True)
    worst = 0.0
    for n, c, h, w_ in tool.SHAPES:
        leg = tool.Leg(n, c, h, w_, torch.bfloat16, False, False, dev)
        tool.bench_kernels(leg, dev, iters=10)
        row = leg.row
        nbytes = 2 * n * c * h * w_ * 2
        x = leg.x
        dst = torch.empty_like(x)
        copy_ms = flushed(lambda: dst.copy_(x))
        k7 = row["copy_ms"]
        worst = max(worst, k7 / copy_ms)
        print("  %-20s %3d %9.4f %9.4f %8.3f %9.4f %9.4f %9.4f %7.2f %7.2f"
              % (row["shape"], fused_bn.bn_copy_channels(x, leg.ng),
                 k7, copy_ms, k7 / copy_ms, nbytes / PEAK_BYTES * 1e3,
                 row["fwd_ms"], row["bwd_ms"], row["fwd_ms"] / k7,
                 row["bwd_ms"] / k7), flush=True)
        if "bn_copy" not in rows:        # the stem: K7's row in the table
            rows["bn_copy"] = dict(ms=k7, plain_ms=flushed(lambda: x.clone()),
                                   library_ms=copy_ms, **_bound(nbytes, 0))
            rows["bn_copy"]["ms_over_library"] = k7 / copy_ms
        del leg, x, dst
    print("  K7/copy_ at most %.3f over the 9 shapes" % worst, flush=True)
    k7_launches = _kernels.launch_counts()["bn_copy"]
    torch.cuda.empty_cache()

    ctx = mx.gpu(dev.index or 0)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    d = LM["dim"] // LM["heads"]
    x = mx.nd.NDArray(torch.randn(LM_BATCH, LM["heads"], LM_SEQ, d,
                                  generator=g, device=dev))
    r1 = kernels["scale_kernel"]
    # one PyTorch call computes 2x + 1: 1 + 2 * x, exact as R1 is
    one = torch.ones((), device=dev)
    if not torch.equal(torch.add(one, x._data, alpha=2),
                       rtc.scale_plain(x._data)):
        raise AssertionError("torch.add(1, x, alpha=2) is not 2x + 1")
    rows["scale_kernel"] = dict(
        ms=flushed(lambda: rtc.launch_scale(r1, x, ctx), "scale_kernel", 20),
        plain_ms=flushed(lambda: rtc.scale_plain(x._data), None, 20),
        library_ms=flushed(lambda: torch.add(one, x._data, alpha=2), None,
                           20),
        **_bound(2 * x.size * 4, 0))
    rows["scale_kernel"]["ms_over_library"] = (
        rows["scale_kernel"]["ms"] / rows["scale_kernel"]["library_ms"])
    print("  R1 at (%d, %d, %d, %d) f32, %d blocks: device %.4f ms a launch, "
          "torch.add(1, x, alpha=2) %.4f, R1/add %.3f (both L2 flushed); "
          "%.4f ms between R1 launches (CUDA events, unflushed: the host's "
          "launch path)" % (
              LM_BATCH, LM["heads"], LM_SEQ, d,
              rtc.scale_grid(x.size, ctx)[0], rows["scale_kernel"]["ms"],
              rows["scale_kernel"]["library_ms"],
              rows["scale_kernel"]["ms_over_library"],
              _time_ms(lambda: rtc.launch_scale(r1, x, ctx), 20)),
          flush=True)
    print("  profiler sessions taken again (trace lost or cut short): %d"
          % tool.retried, flush=True)
    m, k, n = LM_BATCH * LM_SEQ, LM["dim"], LM["dim"]
    a = mx.nd.NDArray(torch.randn(m, k, generator=g, device=dev))
    b = mx.nd.NDArray(torch.randn(k, n, generator=g, device=dev))
    r2 = kernels["mm_kernel"]
    # R2 and torch.matmul on one clock: the profiler's device time
    nbytes, ops = (m * k + k * n + m * n) * 4, 2 * m * n * k
    rows["mm_kernel"] = dict(
        ms=_device_ms(lambda: rtc.launch_mm(r2, a, b, ctx), 10, "mm_kernel"),
        plain_ms=_time_ms(lambda: rtc.mm_plain(a._data, b._data), 10),
        library_ms=_device_ms(lambda: torch.matmul(a._data, b._data), 10),
        **_bound(nbytes, ops))
    _tensor_core_row(rows["mm_kernel"], nbytes, ops)
    print("  R2 at (%d, %d) @ (%d, %d) f32: device %.4f ms a launch, "
          "torch.matmul (TF32 off) device %.4f ms, ms/library %.3f; "
          "tc_bound_ms %.4f; %.4f ms between R2 launches (CUDA events)" % (
              m, k, k, n, rows["mm_kernel"]["ms"],
              rows["mm_kernel"]["library_ms"],
              rows["mm_kernel"]["ms_over_library"],
              rows["mm_kernel"]["tc_bound_ms"],
              _time_ms(lambda: rtc.launch_mm(r2, a, b, ctx), 10)),
          flush=True)
    del x, one, a, b
    torch.cuda.empty_cache()
    return rows, k7_launches


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
    print("[2c] K7 (bn_copy) and the rtc kernels R1/R2 against their plain "
          "versions", flush=True)
    rtc_kernels = check_copy_and_rtc(dev, errs)

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

    print("[3c] nd path: one causal attention layer of the LM (x (%d, %d, "
          "%d), 4 weights (%d, %d), %d heads) with nd + autograd, f32, %d "
          "steps, then R1 and R2 through rtc" % (
              LM_BATCH, LM_SEQ, LM["dim"], LM["dim"], LM["dim"], LM["heads"],
              STEPS), flush=True)
    nd_ms, nd_counts = run_nd_path(dev, rtc_kernels)
    counts.update({name: nd_counts[name] for name in RTC})
    nd_steady = sorted(nd_ms[1:])[len(nd_ms[1:]) // 2]
    print("[3c] nd_step_ms %.2f (median of steps 2-%d)  on %s"
          % (nd_steady, STEPS, card), flush=True)

    print("[4] kernel times (CUDA events, K1/K2 summed over one step's 53 "
          "layers, K4-K6 one layer's attention)", flush=True)
    rows = time_kernels(dev, layers)
    rows.update(time_flash(dev))
    print("[4c] K7 at the 9 ResNet-50 BN shapes (batch 256, bf16) beside "
          "copy_, K1 and K2; R1 beside torch.add; R2 at the nd path's "
          "shapes", flush=True)
    nd_rows, counts["bn_copy"] = time_nd_kernels(dev, rtc_kernels)
    rows.update(nd_rows)
    for name, row in rows.items():
        print("  %-18s ms %.4f  plain_ms %.4f  bound_ms %.4f (%s)  "
              "library_ms %s%s%s" % (
                  name, row["ms"], row["plain_ms"], row["bound_ms"],
                  row["bound_by"], row["library_ms"],
                  "  tc_bound_ms %.4f" % row["tc_bound_ms"]
                  if "tc_bound_ms" in row else "",
                  "  ms/library %.3f" % row["ms_over_library"]
                  if "ms_over_library" in row else ""), flush=True)

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
        "bn_copy": ("incubator_mxnet_tpu_torch/csrc/bn_copy.cu",
                    "tools/bn_kernel_bench.py:99"),
        "scale_kernel": ("incubator_mxnet_tpu_torch/csrc/rtc/scale_kernel.cu",
                         "incubator_mxnet_tpu/rtc.py:37"),
        "mm_kernel": ("incubator_mxnet_tpu_torch/csrc/rtc/mm_kernel.cu",
                      "incubator_mxnet_tpu/rtc.py:37"),
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
