"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they build the kernels with ``nvcc`` and run on an H100,
and skip where there is no card.  Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's host need not
have).  Small shapes; the full-size checks are in ``chip_smoke.py``.

Tolerances: f32 outputs 1e-4 of the reference's largest magnitude (sums
in another order); bf16 outputs 2^-7 of it (one rounding of a value the
two sides compute in f32 may land one bf16 step apart); the f32 sums
dgamma and dbeta 1e-3 of it.  Max pooling is exact, also at every pool
shape of the vision zoo.  A stock-BN train step on the card against the
CPU is held to the CPU's own noise floor (``chip_smoke.py`` phase 5).  Flash attention
(K4-K6): O and LSE 1e-4 in f32 and 2^-7 in bf16, dQ/dK/dV 1e-3 in f32
(sums over every key or query) and 2^-6 in bf16; rows that see no key
exactly 0 in O and dQ; head dims off the kernels' grid (zero-padded to
a multiple of 8) as the rest.  K7 (``bn_copy``) and R1
(``scale_kernel``) exact; R2 (``mm_kernel``) 1e-4 of max |a @ b| (f32 sums in another order
than cuBLAS's); the nd attention layer card against CPU 1e-4 relative.
The record iterator's batches on the card and checkpoints of card
tensors are exact.  The symbolic path: K3 exact at LeNet's two pool
shapes; the max pools outside K3 (1 and 144 window slots, f16, int8)
exact against the CPU with no K3 launch; one LeNet Module step on the
card against the CPU within the noise floor of ``chip_smoke.py`` phase
5d.  The recurrent path: the fused ``RNN`` op through cuDNN against its
plain step loop in every mode (1e-4, the same dropout masks), the
``Embedding`` op's out-of-range rows, and one word-LM step card against
CPU within the noise floor of phase 5e; none launches a kernel.
Detection: each contrib op (``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``box_iou``, ``box_nms`` with tied scores,
``bipartite_matching``, ``ROIPooling``, ``ROIAlign``) on the card against
the CPU: ids, masks, class targets, matches and kept rows equal, anchors
and IoUs 1e-6, location targets, boxes and the ROI ops (with the input
gradient) 1e-5; the SSD300 multibox head of phase 3j-ii and one TinySSD
step within the noise floor of phase 5f; none launches a kernel.
Data parallelism: two ranks over gloo on ``cuda:0``
(``tools/launch_torch.py``, ``tests/torch_dist_worker.py``), the dp step of an
MLP and of ``BasicBlockV1(ghost_bn=4)`` with ``zero=1``: the ranks'
losses, parameters and running stats equal bit for bit, K1/K2 launched
on each rank, and the losses within 1e-4 relative of one process
stepping the whole global batch on the card; a two-rank ZeRO-1
checkpoint written from the card restored by one process at dp=1, its
logical state exact and its next losses within 1e-5.  Model parallelism:
``chip_smoke.py`` phase 3n at a small size (two ranks on ``cuda:0``:
the sequence-parallel LM, ring and Ulysses, the pp=2 step and the ep=2
MoE step against one process on the card, within that phase's limits).
The supervisor: one ``run_supervised`` rollback under ``loss_bomb`` of
``tools/supervise_torch.py``'s job on the card, bit-identical to its
unfaulted run.  Serving: a ``ServeEngine`` bucket's CUDA-graph replay
bit-equal to the eager forward of the same padded batch, one K3 launch a
captured bucket program and none during replays, a row independent of
its batch-mates, a NaN candidate rolled back with the live slot
unchanged; a ``CachedDecoder`` step replayed from its graph against full
recompute over the sliding window (1e-5).  Int8: the seven quantization
ops on the card against the CPU, bit for bit (the padded ``_int_mm``
shapes, the 7x7 stem, grouped and dilated convolutions); the int8
serving tier's codes made on the card equal to the CPU's, its bucket
replay bit-equal to the eager forward with one K3 launch a captured
program, a poisoned swap rolled back with the codes unchanged.  Gluon's
data pipeline: a ``DataLoader``'s batches on the card equal the CPU's
bit for bit, and 2 spawned workers give the thread loader's batches
without initializing CUDA; ``_contrib_DeformableConvolution`` forward and
gradients 1e-5, and ``Estimator.fit`` card against CPU (losses 1e-5
relative, parameters 1e-5), TF32 off.  The op tail, the rest of
``gluon.nn`` and ``contrib.amp``: ``chip_smoke.py`` phase 3u (iii) at a
quarter of its batch (4x the CPU's 1e-6-nudged floor, integer outputs
equal), and one ``amp.init('bfloat16')`` step of the Gluon example's
loop at ``resnet18_v1``, 32 px, card against CPU (phase 3u (i)'s gate).
The last of the op registry: ``chip_smoke.py`` phase 3w (iv) (every new
name of ``ops/parity_tail.py`` and ``ops/contrib_tail.py`` card against
CPU within 4x the CPU's 1e-6-nudged floor, integer outputs equal, the
controls missing) and (iii) at a small map (``Proposal``'s rois and
scores equal); ``Custom`` on the card: callbacks get card arrays, eager,
recorded and ``Executor`` calls agree, a net with an nd-written
``Custom`` is captured by ``ServeEngine`` and replays equal to its eager
forward, and a callback that reads to the host fails the capture.
"""
import importlib

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import _kernels
from incubator_mxnet_tpu_torch.parallel import fused_bn, maxpool_idx

fa = importlib.import_module("incubator_mxnet_tpu_torch.parallel.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _kernels.build()
    return torch.device("cuda", 0)


def _close(a, b, frac):
    b = b.float()
    scale = max(1.0, b.abs().max().item())
    err = (a.float() - b).abs().max().item()
    assert err <= frac * scale, (err, frac * scale)


def _out_tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2.0 ** -7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ng,act,res,dual", [
    ((32, 64, 28, 28), 16, "relu", False, False),
    ((32, 256, 7, 7), 16, "relu", True, True),
    ((32, 512, 14, 14), 8, "relu", True, False),
    ((32, 256, 7, 7), 16, "none", False, False),
    ((16, 2048, 7, 7), 16, "relu", True, False),
    # the shapes that stage their slice over a cluster of CTAs
    ((32, 64, 112, 112), 16, "relu", False, False),
    ((32, 64, 56, 56), 16, "relu", False, False),
    ((32, 256, 56, 56), 16, "relu", True, True),
    # C 3, HW 5: runs of no whole vector, the two-read form
    ((48, 3, 1, 5), 16, "relu", False, False),
    ((48, 3, 1, 5), 16, "relu", True, True),
    # C 16, HW 5: staged runs of 8 (bf16) or 4 (f32) channels, where a
    # 16-byte unit spans up to three channels in bf16
    ((32, 16, 1, 5), 16, "relu", True, True),
    ((32, 16, 1, 5), 16, "none", False, False),
])
def test_ghost_bn_kernels_match_plain(dev, dtype, shape, ng, act, res, dual):
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = (rnd(*shape) * 2 + 0.5).to(dtype)
    r = rnd(*shape).to(dtype) if res else None
    gamma = rnd(shape[1]) * 0.2 + 1
    beta = rnd(shape[1]) * 0.2
    before = _kernels.launch_counts()
    y, m, v = fused_bn.ghost_bn_fwd(x, gamma, beta, r, 1e-5, act, ng)
    yp, mp, vp = fused_bn._gbn_fwd_plain(x, gamma, beta, r, 1e-5, act, ng)
    _close(y, yp, _out_tol(dtype))
    _close(m, mp, 1e-4)
    _close(v, vp, 1e-4)
    gy = rnd(*shape).to(dtype)
    gy2 = rnd(*shape).to(dtype) if dual else None
    ysave = y if res else None
    dx, dg, db, dr = fused_bn.ghost_bn_bwd(gy, gy2, x, ysave, gamma, beta, m,
                                           v, 1e-5, act, ng)
    dxp, dgp, dbp, drp = fused_bn._gbn_bwd_plain(gy, gy2, x, ysave, gamma,
                                                 beta, m, v, 1e-5, act, ng)
    torch.cuda.synchronize()
    _close(dx, dxp, 2 * _out_tol(dtype))
    _close(dg, dgp, 1e-3)
    _close(db, dbp, 1e-3)
    assert (dr is None) == (drp is None)
    if dr is not None:
        _close(dr, drp, _out_tol(dtype))
    after = _kernels.launch_counts()
    assert after["ghost_bn_fwd"] == before["ghost_bn_fwd"] + 1
    assert after["ghost_bn_bwd"] == before["ghost_bn_bwd"] + 1


_STEM = ((1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))


def _pool_input(shape, dtype, g, dev, offset=0):
    """Tie-heavy values (a coarse grid, half clipped to 0 as after a
    ReLU), ``offset`` elements into a fresh buffer (off its 16-byte grid
    for offset > 0)."""
    numel = shape[0] * shape[1] * shape[2] * shape[3]
    x = torch.clamp_min(torch.round(torch.randn(numel + offset, generator=g,
                                                device=dev) * 2) / 2, 0)
    return x.to(dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("case,shape,cfg", [
    # the stem at batch 8: one band a whole plane
    ("stem", (8, 64, 112, 112), _STEM),
    ("2x2/2", (4, 16, 56, 56), ((1, 1, 2, 2), (1, 1, 2, 2),
                                ((0, 0), (0, 0), (0, 0), (0, 0)))),
    ("3x3/1 pad 1", (4, 16, 28, 28), ((1, 1, 3, 3), (1, 1, 1, 1),
                                      ((0, 0), (0, 0), (1, 1), (1, 1)))),
    ("3x3/2 pad (1, 2)", (4, 16, 30, 30), ((1, 1, 3, 3), (1, 1, 2, 2),
                                           ((0, 0), (0, 0), (1, 2), (1, 2)))),
    # odd W: bf16 planes off the 16-byte grid, a scalar head and tail
    ("W 113", (2, 8, 113, 113), _STEM),
    # planes larger than a stage in f32 (360 KB): bands of fewer rows that
    # overlap by kh - sh input rows
    ("300x300", (2, 3, 300, 300), _STEM),
    # a 1x5 window, 5 slots: the generic (not unrolled) window
    ("1x5/1x3", (2, 4, 17, 40), ((1, 1, 1, 5), (1, 1, 1, 3),
                                 ((0, 0), (0, 0), (0, 0), (2, 2)))),
    # rows of 6000: one output row a band in bf16; in f32 three input rows
    # exceed a stage, so the walk reads device memory (unstaged)
    ("W 6000", (1, 2, 8, 6000), _STEM),
])
def test_maxpool_kernel_matches_plain(dev, dtype, case, shape, cfg):
    """K3 bit-exact (out and idx) against its plain version on tie-heavy
    input, one launch a call."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = _pool_input(shape, dtype, g, dev)
    before = _kernels.launch_counts()["maxpool_idx_fwd"]
    out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
    outp, idxp = maxpool_idx._maxpool_plain(x, *cfg)
    torch.cuda.synchronize()
    assert torch.equal(out, outp), case
    assert torch.equal(idx, idxp), case
    assert _kernels.launch_counts()["maxpool_idx_fwd"] == before + 1


#: every distinct max pool of the vision zoo (chip_smoke.ZOO_POOLS, whose
#: table tests/test_torch_pooling.py holds to the models), at batch 2 and
#: up to 32 channels: (label, (C, H, W), kernel, stride, pad, ceil mode)
_ZOO_POOLS = [
    ("resnet stem", (64, 112, 112), 3, 2, 1, False),
    ("vgg", (64, 224, 224), 2, 2, 0, False),
    ("vgg", (128, 112, 112), 2, 2, 0, False),
    ("vgg", (256, 56, 56), 2, 2, 0, False),
    ("vgg", (512, 28, 28), 2, 2, 0, False),
    ("vgg", (512, 14, 14), 2, 2, 0, False),
    ("alexnet", (64, 55, 55), 3, 2, 0, False),
    ("alexnet", (192, 27, 27), 3, 2, 0, False),
    ("alexnet", (256, 13, 13), 3, 2, 0, False),
    ("squeezenet1_0", (96, 109, 109), 3, 2, 0, True),
    ("squeezenet1_0", (256, 54, 54), 3, 2, 0, True),
    ("squeezenet1_0", (512, 27, 27), 3, 2, 0, True),
    ("squeezenet1_1", (64, 111, 111), 3, 2, 0, True),
    ("squeezenet1_1", (128, 55, 55), 3, 2, 0, True),
    ("squeezenet1_1", (256, 27, 27), 3, 2, 0, True),
    ("inception_v3", (64, 147, 147), 3, 2, 0, False),
    ("inception_v3", (192, 71, 71), 3, 2, 0, False),
    ("inception_v3", (288, 35, 35), 3, 2, 0, False),
    ("inception_v3", (768, 17, 17), 3, 2, 0, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("entry", _ZOO_POOLS,
                         ids=lambda e: "%s-%d" % (e[0], e[1][1]))
def test_maxpool_kernel_at_zoo_shapes(dev, dtype, entry):
    """K3 bit-exact (out and idx) against its plain version at each pool
    shape of the zoo (2x2 windows, no padding, ceil mode's high-edge
    padding, odd planes), one launch a call."""
    _, (c, h, w), k, s, p, ceil = entry
    hi = p + s - 1 if ceil else p
    cfg = ((1, 1, k, k), (1, 1, s, s), ((0, 0), (0, 0), (p, hi), (p, hi)))
    g = torch.Generator(device=dev).manual_seed(2)
    x = _pool_input((2, min(c, 32), h, w), dtype, g, dev)
    before = _kernels.launch_counts()["maxpool_idx_fwd"]
    out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
    outp, idxp = maxpool_idx._maxpool_plain(x, *cfg)
    torch.cuda.synchronize()
    assert torch.equal(out, outp)
    assert torch.equal(idx, idxp)
    assert _kernels.launch_counts()["maxpool_idx_fwd"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("layout", ["nan", "offset", "permuted"])
def test_maxpool_kernel_odd_inputs(dev, dtype, layout):
    """K3 against its plain version on NaN inputs (the max is NaN, the
    index keeps its slot), on an input 1-3 elements off the 16-byte grid
    (no copy: the kernel stages the aligned interior and loads the ends),
    and on a permuted tensor (one contiguous copy, then the kernel)."""
    g = torch.Generator(device=dev).manual_seed(2)
    shape = (4, 8, 57, 57)
    if layout == "nan":
        x = _pool_input(shape, dtype, g, dev)
        x.view(-1)[::97] = float("nan")
    elif layout == "offset":
        x = _pool_input(shape, dtype, g, dev, offset=3)
        assert x.data_ptr() % 16
    else:
        x = _pool_input((shape[0], shape[2], shape[3], shape[1]), dtype, g,
                        dev).permute(0, 3, 1, 2)
        assert not x.is_contiguous()
    before = _kernels.launch_counts()["maxpool_idx_fwd"]
    out, idx = maxpool_idx.maxpool_with_index(x, *_STEM)
    outp, idxp = maxpool_idx._maxpool_plain(x, *_STEM)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, outp, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(idx, idxp)
    if layout == "nan":
        assert torch.isnan(out).any()
    assert _kernels.launch_counts()["maxpool_idx_fwd"] == before + 1


@pytest.mark.parametrize("shape,cfg,bf16,f32", [
    ((256, 64, 112, 112), _STEM, 56, 28),
    ((2, 8, 113, 113), _STEM, 57, 29),
    ((2, 3, 300, 300), _STEM, 38, 19),
    ((1, 1, 4, 6000), _STEM, 2, 0)])
def test_maxpool_band_rows_come_from_the_kernel(dev, shape, cfg, bf16, f32):
    """The output rows a band of K3 stages, read from the built library,
    are those tests/test_torch_maxpool_idx.py models from the source's
    MP_* defines: a whole plane at the stem in bf16, half of it in f32,
    bands of 38 and 19 rows at 300x300, and the unstaged form (0) where
    kh input rows exceed a stage (f16 as bf16)."""
    for dtype, want in ((torch.bfloat16, bf16), (torch.float16, bf16),
                        (torch.float32, f32)):
        x = torch.empty(shape, dtype=dtype, device="meta")
        assert maxpool_idx.band_rows(x, *cfg) == want, dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (4, 128, 128, 64, True),      # two full tiles each way
    (3, 100, 100, 128, False),    # ragged last tile, the widest head
    (3, 100, 100, 32, True),
    (2, 96, 40, 16, True),        # Sk < Sq: 56 rows see no key
    (2, 24, 72, 8, True),         # Sk > Sq: the mask's offset is +48
    (2, 8, 200, 40, False),       # D not a multiple of 16
    (2, 200, 200, 128, True),     # Sq not a multiple of K4's 128-row tile
    (2, 300, 136, 128, True),     # ragged on K5/K6's 128- and 32-row tiles
                                  # both ways; 164 rows see no key
    # the D <= 256 form: 64-row blocks, 32- and 16-row tiles, two warps per
    # 16 rows; ragged on them both ways
    (2, 100, 72, 136, True),
    (2, 100, 72, 136, False),
    (2, 72, 130, 200, True),
    (2, 72, 130, 200, False),
    (2, 130, 100, 256, True),     # 30 rows see no key
    (2, 130, 100, 256, False),
    # the D-streamed form: 128-row blocks, 128 output columns a block (the
    # grid's z), scores over 32-column chunks of D; ragged chunks at 264
    # and 1000, ragged tiles both ways
    (2, 100, 72, 264, True),      # 28 rows see no key
    (2, 72, 130, 264, False),
    (2, 130, 100, 512, True),
    (2, 100, 100, 512, False),
    (1, 70, 90, 1000, True),
    (1, 90, 70, 1000, False),
])
def test_flash_kernels_match_plain(dev, dtype, bh, sq, sk, d, causal):
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
    scale = d ** -0.5
    before = _kernels.launch_counts()
    out, lse = fa.flash_fwd(q, k, v, scale, causal)
    outp, lsep = fa._flash_fwd_plain(q, k, v, scale, causal, 8, 8)
    torch.cuda.synchronize()
    tol = _out_tol(dtype)
    _close(out, outp, tol)
    seen = lsep > -5e29
    _close(lse[seen], lsep[seen], 1e-4)
    assert torch.equal(seen, lse > -5e29)
    delta = (do.float() * outp.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lsep, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lsep, delta, scale, causal)
    dqp, dkp, dvp = fa._flash_bwd_plain(q, k, v, do, lsep, delta, scale,
                                        causal, 8, 8)
    torch.cuda.synchronize()
    gtol = 1e-3 if dtype == torch.float32 else 2.0 ** -6
    _close(dq, dqp, gtol)
    _close(dk, dkp, gtol)
    _close(dv, dvp, gtol)
    empty = ~seen
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    assert torch.equal(dq[empty], torch.zeros_like(dq[empty]))
    after = _kernels.launch_counts()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert after[name] == before[name] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (3, 100, 100, 20),       # padded to 24
    (2, 96, 40, 4),          # padded to 8; 56 rows see no key
    (2, 130, 130, 124),      # padded to 128
    (70000, 16, 16, 32),     # b*h over 65535 (the grid's x)
])
def test_flash_head_dims_and_many_heads(dev, dtype, bh, sq, sk, d):
    """Head dims off the kernels' grid, zero-padded along D (K4-K6
    launched once each), and b*h beyond 65535.  Against the plain versions on the unpadded inputs, at
    the tolerances of test_flash_kernels_match_plain."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
    scale = d ** -0.5
    before = _kernels.launch_counts()
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    outp, lsep = fa._flash_fwd_plain(q, k, v, scale, True)
    delta = (do.float() * outp.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lsep, delta, scale, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lsep, delta, scale, True)
    dqp, dkp, dvp = fa._flash_bwd_plain(q, k, v, do, lsep, delta, scale,
                                        True)
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    assert out.shape == q.shape and dq.shape == q.shape
    assert dk.shape == k.shape and dv.shape == v.shape
    _close(out, outp, _out_tol(dtype))
    seen = lsep > -5e29
    _close(lse[seen], lsep[seen], 1e-4)
    gtol = 1e-3 if dtype == torch.float32 else 2.0 ** -6
    for got, want in ((dq, dqp), (dk, dkp), (dv, dvp)):
        _close(got, want, gtol)
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert after[name] == before[name] + 1


@pytest.mark.parametrize("d", [4, 20, 60])
def test_flash_attention_any_head_dim_on_card(dev, monkeypatch, d):
    """The public function at head dims 4, 20 and 60 (padded once for the
    whole call: one launch of each kernel) against the dense reference:
    forward and gradients, f32, TF32 off."""
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    from incubator_mxnet_tpu_torch.parallel.ring_attention import \
        attention_reference

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(10)
    qkv = [torch.randn(2, 3, 144, d, generator=g, device=dev,
                       requires_grad=True) for _ in range(3)]
    w = torch.randn(2, 3, 144, d, generator=g, device=dev)
    grads = []
    before = _kernels.launch_counts()
    for fn in (flash_attention, attention_reference):
        out = fn(*qkv, causal=True)
        grads.append((out,) + torch.autograd.grad((out * w).sum(), qkv))
    after = _kernels.launch_counts()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert after[name] == before[name] + 1
    for a, b in zip(*grads):
        assert a.shape == b.shape
        _close(a, b, 1e-3)


def test_flash_attention_autograd_on_card(dev, monkeypatch):
    """The public function's forward and gradients on the card against the
    dense reference (f32, TF32 off in the einsums)."""
    from incubator_mxnet_tpu_torch.parallel import flash_attention
    from incubator_mxnet_tpu_torch.parallel.ring_attention import \
        attention_reference

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = [torch.randn(2, 4, 160, 64, generator=g, device=dev,
                       requires_grad=True) for _ in range(3)]
    w = torch.randn(2, 4, 160, 64, generator=g, device=dev)
    grads = []
    for fn in (flash_attention, attention_reference):
        out = fn(*qkv, causal=True)
        grads.append((out,) + torch.autograd.grad((out * w).sum(), qkv))
    for a, b in zip(*grads):
        _close(a, b, 1e-3)


def test_dual_cotangents_stay_apart_on_card(dev, monkeypatch):
    """The dual exit's two outputs reach K2 as two cotangents (autograd
    did not merge them), and K2 sums them."""
    seen = []
    orig = fused_bn.ghost_bn_bwd

    def spy(gy, gy2, *a, **k):
        seen.append((gy.clone(), None if gy2 is None else gy2.clone()))
        return orig(gy, gy2, *a, **k)

    monkeypatch.setattr(fused_bn, "ghost_bn_bwd", spy)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(16, 32, 7, 7, generator=g, device=dev,
                    requires_grad=True)
    r = torch.randn(16, 32, 7, 7, generator=g, device=dev)
    gy, gy2 = (torch.randn(16, 32, 7, 7, generator=g, device=dev)
               for _ in range(2))
    y, y_sc, _, _ = fused_bn.ghost_bn_act(
        x, torch.ones(32, device=dev), torch.zeros(32, device=dev), r,
        eps=1e-5, group=16, dual_out=True)
    torch.autograd.backward([y, y_sc], [gy, gy2])
    (g1, g2), = seen
    assert torch.equal(g1, gy) and torch.equal(g2, gy2)


def test_strided_inputs_take_one_copy_on_card(dev):
    """A D-sliced view, a permuted tensor and a storage offset off the
    16-byte grid go through each kernel after at most one contiguous copy
    (one launch a call), with the plain version's result on the same
    inputs: flash attention (K4-K6), max pooling (K3) and ghost BN
    (K1/K2, a channels_last and a permuted x)."""
    g = torch.Generator(device=dev).manual_seed(12)
    wide = torch.randn(2, 80, 96, generator=g, device=dev)
    q = wide[..., :64]                                   # a D-sliced view
    k = torch.randn(80, 2, 64, generator=g, device=dev).transpose(0, 1)
    v = torch.randn(2 * 80 * 64 + 1, generator=g, device=dev)[1:] \
        .view(2, 80, 64)                                 # 4 bytes off 16
    do = torch.randn(2, 64, 80, generator=g, device=dev).transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous() or do.is_contiguous())
    assert v.data_ptr() % 16
    before = _kernels.launch_counts()
    out, lse = fa.flash_fwd(q, k, v, 0.125, True)
    outp, lsep = fa._flash_fwd_plain(q, k, v, 0.125, True)
    delta = (do * outp).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lsep, delta, 0.125, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lsep, delta[:, :], 0.125, True)
    want = fa._flash_bwd_plain(q, k, v, do, lsep, delta, 0.125, True)
    torch.cuda.synchronize()
    _close(out, outp, 1e-4)
    _close(lse, lsep, 1e-4)
    for got, ref in zip((dq, dk, dv), want):
        _close(got, ref, 1e-3)
    # the public function on leaves with the same strides: one launch of
    # each kernel, the same gradients
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*(t[None] for t in qkv), causal=True, scale=0.125)
    o.backward(do[None])
    _close(o[0], outp, 1e-4)
    for t, ref in zip(qkv, want):
        _close(t.grad, ref, 1e-3)
    after = _kernels.launch_counts()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        assert after[name] == before[name] + 2

    x = torch.randn(4, 16, 30, 30, generator=g, device=dev) \
        .to(memory_format=torch.channels_last)
    assert not x.is_contiguous()
    gamma = torch.rand(16, generator=g, device=dev) + 0.5
    beta = torch.randn(16, generator=g, device=dev)
    before = _kernels.launch_counts()
    y, m, var = fused_bn.ghost_bn_fwd(x, gamma, beta, None, 1e-5, "relu", 2)
    yp, mp, vp = fused_bn._gbn_fwd_plain(x, gamma, beta, None, 1e-5, "relu",
                                         2)
    gy = torch.randn(4, 30, 30, 16, generator=g, device=dev) \
        .permute(0, 3, 1, 2)
    dx, dgam, dbet, _ = fused_bn.ghost_bn_bwd(gy, None, x, None, gamma, beta,
                                              m, var, 1e-5, "relu", 2)
    want = fused_bn._gbn_bwd_plain(gy, None, x, None, gamma, beta, m, var,
                                   1e-5, "relu", 2)
    torch.cuda.synchronize()
    _close(y, yp, 1e-4)
    _close(m, mp, 1e-4)
    _close(var, vp, 1e-4)
    _close(dx, want[0], 2e-4)
    _close(dgam, want[1], 1e-3)
    _close(dbet, want[2], 1e-3)
    after = _kernels.launch_counts()
    assert after["ghost_bn_fwd"] == before["ghost_bn_fwd"] + 1
    assert after["ghost_bn_bwd"] == before["ghost_bn_bwd"] + 1


def test_cuda_wrappers_refuse_bad_inputs(dev):
    """What the card still refuses: ghost BN's per-channel vectors off
    float32 or off the card, more than 65535 row tiles (the grid's y) or
    column chunks (its z) of flash attention, checked on the shape before
    any copy or launch, and dtypes no kernel takes.  A strided input is no
    longer refused (test_strided_inputs_take_one_copy_on_card), nor a
    head dim over 256 (test_flash_kernels_match_plain)."""
    x = torch.zeros(4, 8, 3, 3, device=dev)
    g = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_bn.ghost_bn_fwd(x, g.bfloat16(), g, None, 1e-5, "relu", 2)
    with pytest.raises(ValueError, match="on cuda"):
        fused_bn.ghost_bn_fwd(x, g.cpu(), g, None, 1e-5, "relu", 2)
    q = torch.zeros(2, 16, 64, device=dev)
    before = _kernels.launch_counts()
    # more than 65535 row tiles of 128 along the grid's y (checked before
    # the layout: the expanded tensor costs 32 bytes)
    long = torch.zeros(1, 1, 8, device=dev).expand(1, 65535 * 128 + 1, 8)
    with pytest.raises(ValueError, match="65535 tiles"):
        fa.flash_fwd(long, long, long, 1.0, False)
    # more than 65535 chunks of 128 columns along the grid's z
    wide = torch.zeros(1, 1, 1, device=dev).expand(1, 4, 65535 * 128 + 8)
    with pytest.raises(ValueError, match="65535 chunks"):
        fa.flash_fwd(wide, wide, wide, 1.0, False)
    with pytest.raises(ValueError, match="65535 chunks"):
        fa.flash_attention(wide[None], wide[None], wide[None])
    assert _kernels.launch_counts() == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), q.half(), q.half(), 1.0, False)


def test_small_train_step_card_matches_cpu(dev, monkeypatch):
    """One f32 step of the small ghost-BN ResNet on the card and on the
    CPU from the same weights and batch: loss within 1e-4, parameters and
    running stats within 1e-4 (TF32 off)."""
    from incubator_mxnet_tpu_torch import convert, initializer
    from incubator_mxnet_tpu_torch.gluon import loss as tloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    nets = {}
    for d in (dev, torch.device("cpu")):
        nets[d.type] = resnet.ResNetV1(
            resnet.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
            classes=10, ghost_bn=2, device=d)
    initializer.initialize(nets["cuda"],
                           generator=torch.Generator(device=dev).manual_seed(0))
    convert.params_from_jax(nets["cpu"], convert.params_to_numpy(nets["cuda"]))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(4, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4).astype(np.float32))
    losses = {}
    for name, net in nets.items():
        step = make_train_step(net, tloss.SoftmaxCrossEntropyLoss(),
                               learning_rate=0.01, momentum=0.9, wd=1e-4,
                               multi_precision=True, loss_scale="dynamic",
                               device=name)
        losses[name] = step(x, y).item()
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    for a, b in zip(convert.params_to_numpy(nets["cuda"]),
                    convert.params_to_numpy(nets["cpu"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_gluon_fused_step_matches_train_step_on_card(dev, monkeypatch):
    """``Trainer.make_fused_step`` on a small ghost-BN ResNet against
    ``make_train_step`` from the same weights and batches on the card
    (bf16 compute, ``multi_precision``, dynamic loss scale, cuDNN
    deterministic): the losses are equal bit for bit over 3 steps, and
    each side launches the same K1/K2/K3 counts a step."""
    import copy

    from incubator_mxnet_tpu_torch import gluon, initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [16, 32, 64, 128, 256], classes=10, ghost_bn=2,
                          device=dev)
    initializer.initialize(net,
                           generator=torch.Generator(device=dev).manual_seed(0))
    twin = copy.deepcopy(net)
    opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4,
           "multi_precision": True}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    fused = gluon.Trainer(net.collect_params(), "sgd", opt).make_fused_step(
        net, loss_fn, compute_dtype="bfloat16", loss_scale="dynamic",
        device=dev)
    plain = make_train_step(twin, loss_fn, optimizer="sgd",
                            compute_dtype="bfloat16", loss_scale="dynamic",
                            device=dev, **opt)
    names = ("ghost_bn_fwd", "ghost_bn_bwd", "maxpool_idx_fwd")
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(8, 3, 64, 64))
                             .astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.randint(0, 10, 8).astype(np.float32)) \
            .to(dev)
        counts = []
        losses = []
        for step in (fused, plain):
            for n in names:
                _kernels.KERNELS[n].launches = 0
            losses.append(step(x, y))
            torch.cuda.synchronize()
            counts.append([_kernels.KERNELS[n].launches for n in names])
        assert torch.equal(*losses)
        assert counts[0] == counts[1] and min(counts[0]) > 0, counts


def test_stock_bn_step_card_matches_cpu(dev, monkeypatch):
    """One f32 step (TF32 off) of a small stock-BN ResNet v1 (the 7x7/2
    stem, BN, the max pool through K3, [1, 1, 1, 1] bottlenecks of
    widths 16-256, 64 px, batch 4) on the card and on the CPU from the
    same weights, with the noise floor of chip_smoke.py phase 5: the CPU
    step again from weights nudged by 1e-6 (relative).  The loss within
    1e-4 (relative) of the CPU's, the running stats within 1e-3 of each
    tensor's largest magnitude, and the per-tensor relative update
    differences card-vs-CPU at most 4x the nudged-vs-CPU ones plus 1e-3,
    in median and in maximum."""
    from incubator_mxnet_tpu_torch import convert, gluon, initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    where = {"cuda": dev, "cpu": "cpu", "cpu_nudged": "cpu"}
    nets = {}
    for name, d in where.items():
        nets[name] = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                     [16, 32, 64, 128, 256], classes=10,
                                     device=d)
        gluon.shape_init(nets[name], (1, 3, 64, 64))
    initializer.initialize(nets["cuda"],
                           generator=torch.Generator(device=dev).manual_seed(0))
    start = convert.params_to_numpy(nets["cuda"])
    for name in ("cpu", "cpu_nudged"):
        convert.params_from_jax(nets[name], start)
    nudge = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in nets["cpu_nudged"].parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=nudge))
    is_param = [isinstance(t, torch.nn.Parameter)
                for _, t in convert.ordered_tensors(nets["cpu"])]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(4, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4).astype(np.float32))
    losses, after = {}, {}
    for name, net in nets.items():
        before = convert.params_to_numpy(net)
        step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               learning_rate=0.01, momentum=0.9, wd=1e-4,
                               multi_precision=True, loss_scale="dynamic",
                               device=where[name])
        before_k3 = _kernels.launch_counts()["maxpool_idx_fwd"]
        losses[name] = step(x, y).item()
        if name == "cuda":
            assert _kernels.launch_counts()["maxpool_idx_fwd"] == \
                before_k3 + 1
        after[name] = [(a, a - b) for a, b in
                       zip(convert.params_to_numpy(net), before)]

    def rel_update(name):
        return np.array([float(np.abs(u - r).max())
                         / max(float(np.abs(r).max()), 1e-30)
                         for p, (_, u), (_, r) in zip(is_param, after[name],
                                                      after["cpu"]) if p])

    card, noise = rel_update("cuda"), rel_update("cpu_nudged")
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for p, (a, _), (b, _) in zip(is_param, after["cuda"], after["cpu"]):
        if not p:
            assert np.abs(a - b).max() <= 1e-3 * max(1.0, np.abs(b).max())
    assert np.median(card) <= 4 * np.median(noise) + 1e-3
    assert card.max() <= 4 * noise.max() + 1e-3


# ---------------------------------------------------------------------------
# K7 and the rtc kernels R1/R2; the nd path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ng,offset", [
    ((32, 64, 28, 28), 16, 0),
    ((16, 2048, 7, 7), 8, 0),
    ((6, 3, 5, 5), 3, 0),
    ((48, 3, 1, 5), 16, 0),      # C 3, HW 5: runs of no whole vector
    ((32, 64, 7, 7), 16, 0),     # C 64, HW 49: kc 8 (bf16) or 4 (f32)
    ((32, 64, 7, 7), 16, 1),     # x off y's 16-byte grid: all scalar
    ((6, 3, 5, 5), 3, 3),
])
def test_bn_copy_kernel_is_exact(dev, dtype, shape, ng, offset):
    """K7 bit for bit against clone(), also where the runs need a scalar
    head and tail and where x and y differ in alignment mod 16."""
    g = torch.Generator(device=dev).manual_seed(6)
    numel = shape[0] * shape[1] * shape[2] * shape[3]
    x = torch.randn(numel + offset, generator=g, device=dev).to(dtype)
    x = x[offset:].view(shape)
    before = _kernels.launch_counts()["bn_copy"]
    y = fused_bn.bn_copy(x, ng)
    torch.cuda.synchronize()
    assert torch.equal(y.view(-1), x.clone().view(-1))
    assert _kernels.launch_counts()["bn_copy"] == before + 1


@pytest.mark.parametrize("shape,tensors,bf16,f32", [
    ((256, 64, 112, 112), 1, (1, 4), (1, 8)),
    ((256, 64, 112, 112), 2, (1, 8), (1, 8)),
    ((256, 64, 56, 56), 1, (1, 1), (1, 2)),
    ((256, 64, 56, 56), 2, (1, 2), (1, 4)),
    ((256, 256, 56, 56), 4, (1, 4), (1, 8)),
    ((256, 512, 28, 28), 4, (1, 1), (1, 2)),
    ((256, 256, 14, 14), 2, (4, 1), (2, 1)),
    ((256, 2048, 7, 7), 4, (16, 1), (8, 1)),
    ((48, 3, 1, 5), 2, (1, 0), (1, 0))])
def test_ghost_bn_plan_comes_from_the_kernel(dev, shape, tensors, bf16, f32):
    """The channels and the cluster of a K1/K2 block (``tensors`` staged
    tensors: K1 x (+ r), K2 gy and x (+ gy2, + y); ghost group 16), read
    from the built library at ResNet-50 BN shapes, are the header's (as
    tests/test_torch_bn_copy.py models them); C 3 / HW 5 takes the
    two-read form (cluster 0)."""
    for dtype, want in ((torch.bfloat16, bf16), (torch.float32, f32)):
        x = torch.empty(shape, dtype=dtype, device="meta")
        assert fused_bn.ghost_bn_plan(x, 16, tensors) == want, dtype


@pytest.mark.parametrize("shape,kc", [
    ((256, 64, 112, 112), 1), ((256, 256, 28, 28), 1),
    ((256, 256, 14, 14), 4), ((256, 512, 7, 7), 8), ((256, 2048, 7, 7), 16)])
def test_bn_copy_channels_come_from_the_kernel(dev, shape, kc):
    """The channels a block of K7 copies, read from the built library at
    ResNet-50 BN shapes in bf16, are the walk header's."""
    n, c, h, w = shape
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    ng = fused_bn.ghost_group(n, c, h, w, 2, 16)
    assert fused_bn.bn_copy_channels(x, ng) == kc


@pytest.fixture
def rtc_kernels(dev):
    from incubator_mxnet_tpu_torch import rtc

    out = {}
    for name, sig in rtc.USER_KERNELS.items():
        mod = rtc.CudaModule(rtc.user_source(name), exports=[name])
        assert mod.compile_ms > 0
        out[name] = mod.get_kernel(name, sig)
    return out


def test_rtc_kernels_match_plain(dev, rtc_kernels, monkeypatch):
    """R1 exact; R2 within 1e-4 of max |a @ b| (TF32 off), at a ragged
    shape; each launch counted."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import rtc

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(7)
    x = mx.nd.NDArray(torch.randn(3, 1000, 7, generator=g, device=dev))
    y = rtc.launch_scale(rtc_kernels["scale_kernel"], x, mx.gpu(0))
    torch.cuda.synchronize()
    assert torch.equal(y._data, rtc.scale_plain(x._data))
    a = mx.nd.NDArray(torch.randn(130, 70, generator=g, device=dev))
    b = mx.nd.NDArray(torch.randn(70, 65, generator=g, device=dev))
    c = rtc.launch_mm(rtc_kernels["mm_kernel"], a, b, mx.gpu(0))
    _close(c._data, rtc.mm_plain(a._data, b._data), 1e-4)
    assert rtc_kernels["scale_kernel"].launches == 1
    assert rtc_kernels["mm_kernel"].launches == 1


@pytest.mark.parametrize("n", [1, 3, 5, 1000003])
def test_rtc_scale_kernel_lengths_and_offsets(dev, rtc_kernels, n):
    """R1 exact at ragged n, on x and y views 1-3 floats off the 16-byte
    grid together (a scalar head, then float4) and on such an x alone
    through launch_scale (x and y differ mod 16: every element scalar)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import rtc

    r1 = rtc_kernels["scale_kernel"]
    ctx = mx.gpu(0)
    g = torch.Generator(device=dev).manual_seed(11)
    for off in (0, 1, 2, 3):
        xb = torch.randn(n + 4, generator=g, device=dev)
        yb = torch.full((n + 4,), 7.0, device=dev)
        x = mx.nd.NDArray(xb[off:off + n])
        r1.launch([x, mx.nd.NDArray(yb[off:off + n]), n], ctx,
                  rtc.scale_grid(n, ctx), (rtc.SCALE_THREADS, 1, 1))
        y = rtc.launch_scale(r1, x, ctx)
        torch.cuda.synchronize()
        want = rtc.scale_plain(x._data)
        assert torch.equal(yb[off:off + n], want)
        assert torch.equal(yb[:off], torch.full((off,), 7.0, device=dev))
        assert torch.equal(yb[off + n:], torch.full((4 - off,), 7.0,
                                                    device=dev))
        assert torch.equal(y._data, want)
    assert r1.launches == 8


@pytest.mark.parametrize("m,k,n", [
    (257, 33, 130),     # K and N not multiples of 4: 4-byte copies
    (1, 5, 1),
    (300, 64, 260),     # M and N beyond one 128 tile, 16-byte copies
    (129, 1000, 4),
])
def test_rtc_mm_kernel_shapes(dev, rtc_kernels, monkeypatch, m, k, n):
    """R2 within 1e-4 of max |a @ b| (TF32 off in the plain version) at
    ragged and aligned shapes."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import rtc

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(8)
    a = mx.nd.NDArray(torch.randn(m, k, generator=g, device=dev))
    b = mx.nd.NDArray(torch.randn(k, n, generator=g, device=dev))
    c = rtc.launch_mm(rtc_kernels["mm_kernel"], a, b, mx.gpu(0))
    torch.cuda.synchronize()
    want = rtc.mm_plain(a._data, b._data)
    err = (c._data - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert rtc_kernels["mm_kernel"].launches == 1


def test_rtc_refusals_on_card(dev, rtc_kernels):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import rtc

    src = rtc.user_source("scale_kernel")
    with pytest.raises(ValueError, match="not defined"):
        rtc.CudaModule(src, exports=["nope"])
    with pytest.raises(ValueError, match="not found"):
        rtc.CudaModule(src).get_kernel("missing", "const float *x")
    with pytest.raises(RuntimeError, match="NVRTC compile"):
        rtc.CudaModule("extern \"C\" __global__ void k() { undefined(); }")
    k = rtc_kernels["scale_kernel"]
    x = mx.nd.zeros((4,), ctx=mx.gpu(0))
    with pytest.raises(TypeError, match="float32"):
        k.launch([x.astype("float64"), x, 4], mx.gpu(0), (1, 1, 1),
                 (4, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        k.launch([x.as_in_context(mx.cpu()), x, 4], mx.gpu(0), (1, 1, 1),
                 (4, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        k.launch([x, x, 4], mx.cpu(), (1, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="takes 3 arguments"):
        k.launch([x, x], mx.gpu(0), (1, 1, 1), (4, 1, 1))
    assert k.launches == 0


@pytest.mark.parametrize("export", ["axpy", "ns::axpy<float>"])
def test_rtc_export_nvrtc_cannot_resolve_raises_value_error(dev, export):
    """An export that passes the lexical check (its name is in a comment,
    or in another namespace) but that NVRTC cannot resolve."""
    from incubator_mxnet_tpu_torch import rtc

    src = ("// axpy lives in namespace other\n"
           "namespace other { template <typename T> __global__ void "
           "axpy(T a, T *x) {} }\n"
           "extern \"C\" __global__ void k(float *x) {}\n")
    with pytest.raises(ValueError, match=r"export.*axpy.*not defined"):
        rtc.CudaModule(src, exports=[export])
    assert rtc.CudaModule(src, exports=["other::axpy<float>"]) \
        .get_kernel("other::axpy<float>", "float a, float *x").launches == 0


def test_nd_attention_layer_card_matches_cpu(dev, monkeypatch):
    """The chip_smoke [3c] layer at a small size on the card (K4-K6 once
    each) and on the CPU (plain versions) from the same inputs: loss and
    weight gradients within 1e-4 relative."""
    import importlib.util
    import os

    import incubator_mxnet_tpu_torch as mx

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    w = {n: (rng.uniform(-1, 1, (64, 64)) / 8).astype(np.float32)
         for n in ("wq", "wk", "wv", "wo")}
    out = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        wn = {n: mx.nd.array(v, ctx=ctx) for n, v in w.items()}
        for p in wn.values():
            p.attach_grad()
        before = _kernels.launch_counts()
        loss, _, _ = smoke.nd_attention_layer(mx, mx.nd.array(x, ctx=ctx),
                                              wn, 4)
        after = _kernels.launch_counts()
        launched = [after[n] - before[n] for n in smoke.FLASH]
        assert launched == ([1, 1, 1] if ctx.type == "cuda" else [0, 0, 0])
        out[ctx.type] = (loss.asnumpy(), {n: p.grad.asnumpy()
                                          for n, p in wn.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n in w:
        g_cpu = out["cpu"][1][n]
        err = np.abs(out["cuda"][1][n] - g_cpu).max()
        assert err <= 1e-4 * np.abs(g_cpu).max(), (n, err)


def _uint8_shard(tmp_path, n=20, hw=32):
    from incubator_mxnet_tpu_torch import recordio

    prefix = str(tmp_path / "shard")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, (hw, hw, 3)).astype(np.uint8)
        rec.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                           img, img_fmt=".npy"))
    rec.close()
    return prefix


def test_record_iter_card_batches_match_cpu(dev, tmp_path):
    """The uint8 iterator's batches on the card equal its ctx=cpu()
    batches bitwise over three epochs (15 batches), while the hand-off's
    ring recycles its 4 slots of pinned buffers."""
    from incubator_mxnet_tpu_torch import cpu, io

    prefix = _uint8_shard(tmp_path)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 32, 32), batch_size=4, shuffle=True,
              rand_mirror=True, preprocess_threads=2, prefetch_buffer=2)
    its = [io.ImageRecordUInt8Iter(ctx=dev, **kw),
           io.ImageRecordUInt8Iter(ctx=cpu(), **kw)]
    pinned = set()
    for epoch in range(3):
        for card, host in zip(*its):
            d = card.data[0]._data
            assert d.device.type == "cuda" and d.dtype == torch.uint8
            assert torch.equal(d.cpu(), host.data[0]._data)
            assert torch.equal(card.label[0]._data.cpu(), host.label[0]._data)
            pinned.update(b.data_ptr() for slot in its[0]._to_device._slots
                          if slot for b in slot[0])
        for it in its:
            it.reset()
    assert 0 < len(pinned) <= 2 * 4
    assert its[0].h2d_ms() > 0 and its[1].h2d_ms() is None
    for it in its:
        it.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_on_card(dev, tmp_path, dtype):
    """Card tensors saved by the port's manager come back on the card,
    bitwise, in their dtype."""
    from incubator_mxnet_tpu_torch.parallel import checkpoint

    g = torch.Generator(device=dev).manual_seed(0)
    state = {"w": [torch.randn(33, 17, generator=g, device=dev).to(dtype)],
             "s": (torch.tensor(3, dtype=torch.int32, device=dev),)}
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    like = {"w": [torch.zeros(33, 17, dtype=dtype, device=dev)],
            "s": (torch.zeros((), dtype=torch.int32, device=dev),)}
    step, got = mgr.restore(like)
    assert step == 1
    for a, b in ((state["w"][0], got["w"][0]), (state["s"][0], got["s"][0])):
        assert b.device == dev and b.dtype == a.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the symbolic path: LeNet's pools, C4, a Module step
# ---------------------------------------------------------------------------


def _smoke():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("shape", [(64, 20, 24, 24), (64, 50, 8, 8)])
def test_maxpool_kernel_at_lenet_shapes(dev, shape, dtype):
    """K3 bit-exact (out and idx) against its plain version at LeNet's
    pools (train_mnist_torch.py's batch 64), one launch a call."""
    cfg = _smoke().LENET_POOL
    g = torch.Generator(device=dev).manual_seed(3)
    x = _pool_input(shape, dtype, g, dev)
    before = _kernels.launch_counts()["maxpool_idx_fwd"]
    out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
    outp, idxp = maxpool_idx._maxpool_plain(x, *cfg)
    torch.cuda.synchronize()
    assert torch.equal(out, outp) and torch.equal(idx, idxp)
    assert _kernels.launch_counts()["maxpool_idx_fwd"] == before + 1


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, (1, 1)), (torch.float32, (12, 12)),
    (torch.float16, (1, 1)), (torch.float16, (12, 12)),
    (torch.float64, (12, 12)), (torch.int8, (3, 3)),
])
def test_max_pool_outside_k3_on_card(dev, dtype, kernel):
    """C4 on the card: the max pools the reference computes outside its
    kernel (1 slot, more than 127, integers) run in stock torch ops,
    equal to the CPU's, forward and gradient, with no K3 launch."""
    from incubator_mxnet_tpu_torch.ops import nn as tops

    g = torch.Generator().manual_seed(4)
    x = torch.clamp_min(torch.round(torch.randn(2, 3, 16, 16, generator=g)
                                    * 4), 0).to(dtype)
    floating = dtype.is_floating_point
    kw = dict(kernel=kernel, pool_type="max", stride=(1, 1))
    outs = {}
    for where in ("cpu", dev):
        xt = x.clone().to(where).requires_grad_(floating)
        before = _kernels.launch_counts()["maxpool_idx_fwd"]
        out = tops.pooling(xt, **kw)
        grad = None
        if floating:
            out.backward(torch.linspace(-1, 1, out.numel()).reshape(
                out.shape).to(dtype).to(where))
            grad = xt.grad.cpu()
        assert _kernels.launch_counts()["maxpool_idx_fwd"] == before
        outs[str(where)] = (out.detach().cpu(), grad)
    (a, ga), (b, gb) = outs.values()
    assert torch.equal(a, b)
    assert ga is None or torch.equal(ga, gb)


def test_lenet_module_step_card_matches_cpu(dev, monkeypatch):
    """chip_smoke.py phase 5d: one f32 LeNet Module step (batch 16) on the
    card against the CPU, held to the CPU's nudged-weights noise floor,
    and the same step with TF32 on failing those limits (two K3 launches
    a card step)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = _kernels.launch_counts()["maxpool_idx_fwd"]
    _smoke().mnist_card_vs_cpu(dev)
    assert _kernels.launch_counts()["maxpool_idx_fwd"] == before + 4


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_cudnn_matches_plain(dev, monkeypatch, mode):
    """The fused RNN op through cuDNN against its plain step loop on the
    card (f32, TF32 off): 2 layers, two directions, a batch-1 begin
    state; output, final states and the gradients of input, flat vector
    and states within 1e-4; with dropout in training both routes draw
    the same masks from equal generators; no kernel of the port
    launched."""
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(3)
    t, n, c, h = 7, 5, 9, 6
    size = rnn_ops.rnn_param_size(2, c, h, mode, True)
    x = torch.randn(t, n, c, generator=g, device=dev)
    w = (torch.rand(size, generator=g, device=dev) - 0.5)
    hs = torch.randn(4, 1, h, generator=g, device=dev)
    cs = torch.randn(4, 1, h, generator=g, device=dev)
    before = _kernels.launch_counts()
    for p, training in ((0.0, False), (0.3, True)):
        res = []
        for fn in (rnn_ops.rnn, rnn_ops.rnn_plain):
            ins = [v.clone().requires_grad_() for v in (x, w, hs, cs)]
            outs = fn(*ins, state_size=h, num_layers=2, mode=mode,
                      bidirectional=True, p=p, state_outputs=True,
                      training=training,
                      generator=torch.Generator(device=dev).manual_seed(9))
            sum((o * torch.cos(o)).sum() for o in outs).backward()
            res.append(list(outs) + [v.grad if v.grad is not None
                                     else torch.zeros_like(v) for v in ins])
        for a, b in zip(*res):
            _close(a, b, 1e-4)
    assert _kernels.launch_counts() == before


def test_embedding_out_of_range_on_card(dev):
    """Indices outside [-n, n) give NaN rows on the card too (no device
    assert), negative ones count from the end; card equals CPU."""
    from incubator_mxnet_tpu_torch.ops import tensor

    w = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([[0.0, 3.5, -1.0], [4.0, -5.0, 2.0]])
    cpu = tensor._embedding(idx, w)
    card = tensor._embedding(idx.to(dev), w.to(dev)).cpu()
    assert torch.equal(torch.isnan(card), torch.isnan(cpu))
    assert torch.equal(card.nan_to_num(), cpu.nan_to_num())
    assert torch.isnan(card[1, :2]).all() and torch.equal(card[0, 2], w[3])


def test_word_lm_step_card_matches_cpu(dev):
    """chip_smoke.py phase 5e: one f32 step of train_torch.py's WordLM
    (vocab 256, 64/128 wide, batch 8, bptt 16) on the card against the
    CPU, held to the CPU's nudged-weights noise floor; no kernel of the
    port launched."""
    before = _kernels.launch_counts()
    _smoke().word_lm_card_vs_cpu(dev)
    assert _kernels.launch_counts() == before


def _contrib_case(case):
    """(op name, CPU inputs, attributes) of a small detection case."""
    from incubator_mxnet_tpu_torch.ops import registry

    prior = registry.OPS["_contrib_MultiBoxPrior"].fn
    rng = np.random.RandomState(8)
    anchors = prior(torch.zeros(1, 3, 6, 6), sizes=(0.3, 0.5),
                    ratios=(1.0, 2.0))
    a = anchors.shape[1]
    lab = np.full((3, 5, 5), -1.0, np.float32)
    for i, k in enumerate((2, 0, 5)):
        xy = rng.rand(k, 2) * 0.6
        lab[i, :k] = np.concatenate([rng.randint(0, 3, (k, 1)), xy,
                                     xy + rng.rand(k, 2) * 0.4 + 0.05], 1)
    logits = torch.from_numpy(rng.randn(3, 4, a).astype(np.float32))
    loc = torch.from_numpy((rng.randn(3, a * 4) * 0.3).astype(np.float32))
    rows = np.concatenate([
        rng.randint(0, 3, (2, 40, 1)), rng.rand(2, 40, 1),
        rng.rand(2, 40, 2) * 0.5, rng.rand(2, 40, 2) * 0.5 + 0.3],
        -1).astype(np.float32)
    rows[:, 5:9] = rows[:, 0:4]            # tied scores on identical boxes
    rows[:, 12, 1] = rows[:, 11, 1]        # tied scores, distinct boxes
    data = torch.from_numpy(rng.randn(2, 3, 12, 14).astype(np.float32))
    rois = torch.tensor([[0, 1, 2, 9, 10], [1, 0, 0, 13, 11],
                         [0, 3.5, 2.2, 7.7, 6.1]])
    boxes = torch.from_numpy(rng.rand(2, 6, 4).astype(np.float32))
    return {
        "prior": ("_contrib_MultiBoxPrior", [torch.zeros(2, 3, 5, 7)],
                  dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5, 3, 1 / 3),
                       steps=(0.125, 0.1), clip=True)),
        "iou_center": ("_contrib_box_iou", [boxes, boxes[0]],
                       dict(format="center")),
        "target": ("_contrib_MultiBoxTarget",
                   [anchors, torch.from_numpy(lab), logits], {}),
        "target_mining": ("_contrib_MultiBoxTarget",
                          [anchors, torch.from_numpy(lab), logits],
                          dict(negative_mining_ratio=3.0)),
        "detection": ("_contrib_MultiBoxDetection",
                      [torch.softmax(logits, 1), loc, anchors],
                      dict(nms_threshold=0.3)),
        "detection_force_topk": ("_contrib_MultiBoxDetection",
                                 [torch.softmax(logits, 1), loc, anchors],
                                 dict(nms_threshold=0.3, force_suppress=True,
                                      nms_topk=20)),
        "nms_ties": ("_contrib_box_nms", [torch.from_numpy(rows)],
                     dict(overlap_thresh=0.4, id_index=0, topk=12,
                          out_format="center")),
        "bipartite": ("_contrib_bipartite_matching",
                      [torch.from_numpy(rows[..., 2:6])], dict(threshold=0.3)),
        "roi_pooling": ("ROIPooling", [data, rois],
                        dict(pooled_size=(3, 2), spatial_scale=0.9)),
        "roi_align": ("_contrib_ROIAlign", [data, rois],
                      dict(pooled_size=(3, 2), spatial_scale=0.9)),
    }[case]


@pytest.mark.parametrize("case", [
    "prior", "iou_center", "target", "target_mining", "detection",
    "detection_force_topk", "nms_ties", "bipartite", "roi_pooling",
    "roi_align"])
def test_contrib_op_card_matches_cpu(dev, case):
    from incubator_mxnet_tpu_torch.ops import registry

    name, ins, kw = _contrib_case(case)
    fn = registry.OPS[name].fn
    grad = name in ("ROIPooling", "_contrib_ROIAlign")
    before = _kernels.launch_counts()
    xs = {d: [t.detach().to(d).requires_grad_(grad and i == 0)
              for i, t in enumerate(ins)] for d in ("cpu", dev)}
    outs = {}
    for d, args in xs.items():
        out = fn(*args, **kw)
        outs[d] = list(out) if isinstance(out, (tuple, list)) else [out]
        if grad:
            (outs[d][0] * torch.cos(outs[d][0].detach())).sum().backward()
    got = [o.detach() for o in outs[dev]]
    want = [o.detach() for o in outs["cpu"]]
    assert [(g.device, g.dtype) for g in got] == [(dev, w.dtype)
                                                  for w in want]
    got = [g.cpu() for g in got]
    if name in ("_contrib_MultiBoxPrior", "_contrib_box_iou"):
        assert (got[0] - want[0]).abs().max().item() <= 1e-6
    elif name == "_contrib_MultiBoxTarget":
        _close(got[0], want[0], 1e-5)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    elif name in ("_contrib_MultiBoxDetection", "_contrib_box_nms"):
        assert torch.equal(got[0][..., :2] == -1, want[0][..., :2] == -1)
        assert torch.equal(got[0][..., 0], want[0][..., 0])
        assert (got[0] - want[0]).abs().max().item() <= 1e-5
    elif name == "_contrib_bipartite_matching":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        _close(got[0], want[0], 1e-5)
    if grad:
        _close(xs[dev][0].grad.cpu(), xs["cpu"][0].grad, 1e-5)
    assert _kernels.launch_counts() == before


def test_ssd300_multibox_head_card_matches_cpu(dev):
    """chip_smoke.py phase 3j-ii: the SSD300 multibox head (8732 anchors,
    batch 32) on the card against the CPU."""
    before = _kernels.launch_counts()
    m = _smoke().run_multibox_ssd300(dev)
    assert m["positives"] > 0 and m["negatives"] > 0 and m["kept"] > 0
    assert _kernels.launch_counts() == before


def test_ssd_step_card_matches_cpu(dev):
    """chip_smoke.py phase 5f: one f32 TinySSD step (batch 16) on the card
    against the CPU, held to the CPU's nudged-weights noise floor; no
    kernel of the port launched."""
    before = _kernels.launch_counts()
    _smoke().ssd_card_vs_cpu(dev)
    assert _kernels.launch_counts() == before


GHOST_FORMS = [
    ("_contrib_GhostBNReLU", False), ("_contrib_GhostBN", False),
    ("_contrib_GhostBNAddReLU", True), ("_contrib_GhostBNAddReLUDual", True),
    ("_contrib_GhostBNReLUNS", False), ("_contrib_GhostBNNS", False)]


@pytest.mark.parametrize("name,residual", GHOST_FORMS,
                         ids=[n for n, _ in GHOST_FORMS])
def test_ghost_registry_forms_on_card_match_plain(dev, name, residual):
    """Each ghost-BN registry op in training on the card (K1, and K2 on
    backward: one launch each) against the same op on the CPU (the plain
    versions): outputs, statistics and every input's gradient, to this
    file's f32 limits; the running-stat update of the stateful forms."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.ops import registry

    op = registry.OPS[name]
    rng = np.random.RandomState(3)
    n, c, hw = 16, 64, 7
    ins = [rng.normal(0.5, 2.0, (n, c, hw, hw))]
    if residual:
        ins.append(rng.normal(size=(n, c, hw, hw)))
    ins += [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.2, c)]
    stateful = not name.endswith("NS")
    if stateful:
        ins += [rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c)]
    ins = [torch.tensor(a, dtype=torch.float32) for a in ins]
    kw = dict(eps=1e-5, group=8)
    if stateful:
        kw["momentum"] = 0.9
    cots = [torch.tensor(rng.normal(size=(n, c, hw, hw)), dtype=torch.float32)
            for _ in range(2)]
    res = {}
    for key, d in (("cpu", torch.device("cpu")), ("card", dev)):
        xs = [t.detach().clone().to(d).requires_grad_(
            i < (4 if residual else 3)) for i, t in enumerate(ins)]
        _kernels.reset_launch_counts()
        with autograd.train_mode():
            out = op.fn(*xs, **kw)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        live = [o for o in outs if o.requires_grad]
        torch.autograd.backward(live, [g.to(d) for g in cots[:len(live)]])
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        upd = op.aux_update([t.detach() for t in xs], outs, momentum=0.9) \
            if op.aux_update else {}
        res[key] = ([o.detach().cpu() for o in outs],
                    [None if t.grad is None else t.grad.cpu() for t in xs],
                    {k: v.cpu() for k, v in upd.items()}, counts)
    (o_card, g_card, u_card, counts), (o_cpu, g_cpu, u_cpu, _) = \
        res["card"], res["cpu"]
    assert counts["ghost_bn_fwd"] == 1 and counts["ghost_bn_bwd"] == 1
    for a, b in zip(o_card, o_cpu):
        _close(a, b, 1e-4)
    for i, (a, b) in enumerate(zip(g_card, g_cpu)):
        assert (a is None) == (b is None)
        if a is not None:  # dgamma and dbeta are sums over the group
            _close(a, b, 1e-4 if i < (2 if residual else 1) else 1e-3)
    assert sorted(u_card) == sorted(u_cpu) == (
        sorted(op.mutate_idx) if stateful else [])
    for k in u_card:
        _close(u_card[k], u_cpu[k], 1e-4)


def _ghost_symbol(sym, c=64, group=8):
    x = sym.Convolution(sym.var("data"), kernel=(3, 3), pad=(1, 1),
                        num_filter=c, no_bias=True, name="c0")
    a = sym.contrib.GhostBNReLU(x, eps=1e-5, group=group, name="g0")[0]
    d = sym.contrib.GhostBNAddReLUDual(
        sym.Convolution(a, kernel=(1, 1), num_filter=c, no_bias=True,
                        name="c1"), a, eps=1e-5, group=group, name="g1")
    return sym.contrib.GhostBNAddReLU(d[0], d[1], eps=1e-5, group=group,
                                      name="g2")[0]


def test_simple_bind_through_ghost_ops_launches_nothing(dev):
    """``simple_bind`` on the card infers shapes through the ghost ops and
    a max pool on ``meta`` tensors: K1/K2/K3's wrappers answer them, no
    kernel launches; the bound Executor's training step then launches K1
    three times, K2 three times and K3 once."""
    import incubator_mxnet_tpu_torch as mx

    s = mx.sym.Pooling(_ghost_symbol(mx.sym), kernel=(3, 3), stride=(2, 2),
                       pad=(1, 1), pool_type="max")
    shapes = {n: (64,) for n in s.list_inputs()
              if n.endswith(("gamma", "beta", "moving_mean", "moving_var"))}
    _kernels.reset_launch_counts()
    exe = s.simple_bind(dev, data=(16, 3, 14, 14), **shapes)
    assert not any(_kernels.launch_counts().values())
    assert exe.outputs == [] and exe.arg_dict["data"].shape == (16, 3, 14, 14)
    for name in shapes:
        arrays = exe.arg_dict if name in exe.arg_dict else exe.aux_dict
        arrays[name][:] = 1.0 if name.endswith(("gamma", "var")) else 0.0
    exe.arg_dict["data"][:] = mx.nd.random.uniform(shape=(16, 3, 14, 14),
                                                   ctx=dev)
    exe.forward(is_train=True)
    exe.backward()
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert (counts["ghost_bn_fwd"], counts["ghost_bn_bwd"],
            counts["maxpool_idx_fwd"]) == (3, 3, 1)


def test_exported_ghost_net_executor_matches_gluon_on_card(dev, tmp_path):
    """chip_smoke.py phase 3k at a small size: ``resnet18_v1(ghost_bn=8)``
    exported and bound on the card; one Executor training step equals
    the Gluon net's step bit for bit (output, argument gradients,
    running stats; cuDNN deterministic), each launching K1/K2/K3
    20/20/1 times (16 block BNs, 3 downsample BNs and the stem's);
    ``SymbolBlock.imports`` in inference equals the Gluon net's eval
    output."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        net = resnet.resnet18_v1(classes=10, ghost_bn=8, device=dev)
        initializer.initialize(net, initializer.Xavier(),
                               torch.Generator(device=dev).manual_seed(0))
        prefix = str(tmp_path / "r18")
        net.export(prefix)
        x = mx.nd.random.uniform(shape=(16, 3, 32, 32), ctx=dev)
        head = mx.nd.random.normal(shape=(16, 10), ctx=dev)
        block = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                             prefix + "-0000.params", ctx=dev)
        assert torch.equal(block(x)._data, net(x)._data)
        sym, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=dev)
        exe = sym.simple_bind(dev, data=x.shape)
        exe.copy_params_from(args, aux)
        want = {"ghost_bn_fwd": 20, "ghost_bn_bwd": 20, "maxpool_idx_fwd": 1}
        _kernels.reset_launch_counts()
        exe.forward(is_train=True, data=x)
        exe.backward(head)
        torch.cuda.synchronize()
        assert {k: v for k, v in _kernels.launch_counts().items() if v} \
            == want
        _kernels.reset_launch_counts()
        with mx.autograd.record():
            y = net(x)
        y.backward(head)
        torch.cuda.synchronize()
        assert {k: v for k, v in _kernels.launch_counts().items() if v} \
            == want
        params = net.collect_params()
        assert torch.equal(exe.outputs[0]._data, y._data)
        for n, g in exe.grad_dict.items():
            if n != "data":
                assert torch.equal(g._data, params[n].grad()._data), n
        for n, a in exe.aux_dict.items():
            assert torch.equal(a._data, params[n].data()._data), n
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True


def test_control_flow_and_linalg_card_match_cpu(dev):
    """chip_smoke.py phase 3k's last part: the LSTM-like ``foreach``, a
    ``while_loop`` and a ``cond``, and potrf/trsm/syevd/gelqf/slogdet,
    card against CPU within the script's limits; no kernel launched."""
    _smoke().control_flow_linalg_card_vs_cpu(dev)


#: the two-rank card test's bf16 conv-BN case against one process on the
#: same global batch: each step's loss (relative; the two bf16 half
#: means against one bf16 mean), the running stats (relative to each
#: tensor's largest magnitude, at least 1) and the update's relative L2
#: difference over every trained tensor.  On the H100 the two ranks read
#: 3.3e-3, 1.7e-4 and 1.2e-2, the step on rank 0's half alone 5.3e-2,
#: 6.5e-3 and 0.57
DP_BF16_TOL = dict(loss=2.0 ** -7, stats=1e-3, update=0.1)


def _dp_one_process(dev, c, inputs, rows=None):
    """Case ``c`` of the two-rank card test stepped by one process on
    the whole global batches (or their first ``rows`` images alone) from
    the same weights: (losses, the state after, the state before, which
    tensors train)."""
    import torch_dist_worker as w

    from incubator_mxnet_tpu_torch import convert, gluon
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    name = c["name"]
    net = w.build_net(c["net"], c["image"], dev)
    convert.params_from_jax(net, [inputs["%s.w%d" % (name, i)] for i in
                                  range(len(convert.ordered_tensors(net)))])
    start = convert.params_to_numpy(net)
    grads = {n for n, p in net.named_parameters() if p.requires_grad}
    trained = [n in grads for n, _ in convert.ordered_tensors(net)]
    step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           device=dev, **c["opt"])
    losses = []
    for s in range(c["steps"]):
        x = torch.from_numpy(inputs["%s.x%d" % (name, s)])[:rows]
        y = torch.from_numpy(inputs["%s.y%d" % (name, s)])[:rows]
        losses.append(float(step(x.to(dev), y.to(dev))))
    return losses, convert.params_to_numpy(net), start, trained


def _dp_bf16_readings(losses, state, one):
    """(largest loss, running-stat and update differences) of a run
    against :func:`_dp_one_process`'s, as ``DP_BF16_TOL`` measures them."""
    ref_losses, ref_state, start, trained = one
    loss = float(np.max(np.abs(np.array(losses) - ref_losses)
                        / np.abs(ref_losses)))
    num = den = stats = 0.0
    for t, a, b, s0 in zip(trained, state, ref_state, start):
        a, b = a.astype(np.float64), b.astype(np.float64)
        if t:
            num += float(np.square(a - b).sum())
            den += float(np.square(b - s0).sum())
        else:
            stats = max(stats, float(np.abs(a - b).max())
                        / max(1.0, float(np.abs(b).max())))
    return dict(loss=loss, stats=stats, update=(num / den) ** 0.5)


def test_dp_step_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device): bit-identical replicas, ghost BN on K1/K2 in each rank, the
    one-process step's losses on the same global batch (f32, lr 0.01, 3
    steps) within 1e-4 relative, and every eager collective exact on
    CUDA tensors.  The cifar10 example's conv-BN net in bf16 (stock BN
    through the synced BN of ``ops/nn.py`` in each rank, K3 at its max
    pool) is held to the one-process bf16 step within ``DP_BF16_TOL``, a
    limit that the same step on rank 0's half alone must miss."""
    import json

    import torch_dist_launch
    import torch_dist_worker as w

    from incubator_mxnet_tpu_torch import convert

    opt = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9, wd=1e-4,
               multi_precision=True)
    cases = [dict(name="mlp", net="mlp", image=0, zero=1, opt=opt, steps=3,
                  shape=(8, 10), classes=13),
             dict(name="block", net="block", image=12, zero=1,
                  opt=dict(opt, loss_scale="dynamic"), steps=3,
                  shape=(16, 3, 12, 12), classes=10),
             dict(name="convbn", net="convbn", image=16, zero=1,
                  opt=dict(opt, compute_dtype="bfloat16"), steps=3,
                  shape=(16, 3, 16, 16), classes=10)]
    inputs = {}
    rng = np.random.RandomState(0)
    for c in cases:
        net = w.build_net(c["net"], c["image"], torch.device("cpu"))
        for i, a in enumerate(convert.params_to_numpy(net)):
            inputs["%s.w%d" % (c["name"], i)] = a
        for s in range(c["steps"]):
            inputs["%s.x%d" % (c["name"], s)] = \
                rng.normal(size=c["shape"]).astype(np.float32)
            inputs["%s.y%d" % (c["name"], s)] = rng.randint(
                0, c["classes"], c["shape"][0]).astype(np.float32)
    np.savez(str(tmp_path / "inputs.npz"), **inputs)
    with open(str(tmp_path / "cases.json"), "w") as f:
        json.dump([{k: v for k, v in c.items() if k not in ("shape",
                                                              "classes")}
                   for c in cases], f)
    ranks = torch_dist_launch.finish(
        torch_dist_launch.start("step", tmp_path, platform="cuda"), tmp_path,
        timeout=300)
    assert str(ranks[0]["backend"]) == "gloo"
    for r, got in enumerate(ranks):
        for k, want in w.collectives_expected(r, 2).items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    for c in cases:
        name = c["name"]
        keys = [k for k in ranks[0] if k.startswith(name + ".")]
        for k in keys:
            if k.endswith((".collectives", ".kernels")):
                continue
            assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
        one = _dp_one_process(dev, c, inputs)
        if c["opt"].get("compute_dtype") != "bfloat16":
            np.testing.assert_allclose(ranks[0][name + ".loss"], one[0],
                                       rtol=1e-4)
            continue
        state = [ranks[0]["%s.p%d" % (name, i)] for i in range(len(one[1]))]
        got = _dp_bf16_readings(ranks[0][name + ".loss"], state, one)
        half = c["shape"][0] // 2
        alone = _dp_one_process(dev, c, inputs, rows=half)
        missed = _dp_bf16_readings(alone[0], alone[1], one)
        assert all(got[k] <= v for k, v in DP_BF16_TOL.items()), \
            (got, DP_BF16_TOL)
        assert missed["update"] > DP_BF16_TOL["update"] and \
            missed["stats"] > DP_BF16_TOL["stats"], (missed, DP_BF16_TOL)
    for r in ranks:
        launched = json.loads(str(r["block.kernels"]))
        # 3 ghost BNs a forward, 3 steps
        assert launched["ghost_bn_fwd"] == launched["ghost_bn_bwd"] == 9
        # the conv-BN net's max pool, 3 steps
        assert json.loads(str(r["convbn.kernels"]))["maxpool_idx_fwd"] == 3


def test_two_rank_checkpoint_on_the_card_restores_at_dp1(dev, tmp_path):
    """A two-rank ZeRO-1 step sharing the card over gloo (the elastic
    net of ``tests/torch_dist_worker.py``: two ``Dense(16, tanh)``, a
    ragged ``Dense(13)``, adam, a dynamic loss scale) commits a
    checkpoint of step 3 with each rank's iterator state; one process on
    the card restores it at dp=1: the logical state equals the ranks' bit
    for bit, the next batches are the ones the ranks drew, and the losses
    agree within 1e-5 (another sum order)."""
    import torch_dist_launch
    import torch_dist_worker as w

    from incubator_mxnet_tpu_torch import convert
    from incubator_mxnet_tpu_torch.parallel import make_mesh

    net = w.elastic_net(torch.device("cpu"))
    np.savez(str(tmp_path / "inputs.npz"),
             **{"el.w%d" % i: a
                for i, a in enumerate(convert.params_to_numpy(net))})
    (tmp_path / "jax_ready").write_text("")  # no JAX on the card's host
    ranks = torch_dist_launch.finish(
        torch_dist_launch.start("elastic_save", tmp_path, platform="cuda"),
        tmp_path, timeout=300)
    mesh = make_mesh({"dp": 1}, devices=[dev])
    step = w.elastic_step(w.elastic_net(dev, seed=17), dev, mesh)
    it = w.elastic_iter(12)
    assert step.restore_checkpoint(str(tmp_path / "ckpt_dp2"),
                                   data_iter=it) == 3
    got = w.logical_parts(step, "a3.")
    for k, a in got.items():
        if k.startswith("a3.o"):
            want = np.concatenate([r[k] for r in ranks])
        else:
            want = ranks[0][k]
            assert ranks[1][k].tobytes() == want.tobytes(), k
        assert a.tobytes() == want.tobytes(), k
    for k in range(3):
        b = it.next()
        np.testing.assert_array_equal(b.index, ranks[0]["a.idx"][3 + k])
        loss = w.elastic_feed(step, mesh, b, dev)
        assert abs(loss - ranks[0]["a.loss"][3 + k]) <= 1e-5
    it.close()


#: ``chip_smoke.py`` phase 3n at a small size
MP_SMALL = {"lm": dict(vocab=64, dim=128, heads=4, layers=2, seq=256,
                       batch=2, lr=0.01, steps=3),
            "pp": dict(width=64, layers=8, classes=16, batch=64,
                       num_micro=4, steps=3),
            "moe": dict(width=64, hidden=128, experts=8, top_k=2,
                        capacity=2.0, classes=16, tokens=256, lr=0.1,
                        steps=3)}


def test_model_parallel_two_ranks_on_one_card(dev):
    """Phase 3n of ``chip_smoke.py`` at ``MP_SMALL``: two ranks over gloo
    on the card run ``train_lm_torch.py --devices 2`` (ring, then Ulysses
    with K4/K5/K6 launched 2/2/2 a rank a step), the pp=2 step and the
    ep=2 MoE step, each held to one process on the card by the phase's
    gates (which raise)."""
    smoke = _smoke()
    launches = smoke.run_mp_job(dev, "test", MP_SMALL)
    for name in smoke.FLASH:
        assert launches[name] == MP_SMALL["lm"]["layers"] * \
            MP_SMALL["lm"]["steps"]


def _supervise_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "supervise_torch.py")
    spec = importlib.util.spec_from_file_location("supervise_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_supervised_rollback_on_the_card(dev, tmp_path):
    """``run_supervised`` on the card with ``tools/supervise_torch.py``'s
    job under ``loss_bomb`` at call 4: the divergence verdict rolls back
    to step 4, and the losses after the rollback and the final parameters
    equal the unfaulted run's bit for bit."""
    import contextlib

    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.parallel import supervisor as sup

    tool = _supervise_tool()
    runs = []
    for name, bomb in (("clean", None), ("bomb", 4)):
        step, it, mgr, cfg = tool.build_worker_job(str(tmp_path / name))[:4]
        assert step.device.type == "cuda"
        ctx = fi.loss_bomb(at=bomb, factor=1e4) if bomb is not None \
            else contextlib.nullcontext()
        with ctx:
            out = sup.run_supervised(step, it, mgr, until_step=10,
                                     config=cfg)
        it.close()
        runs.append((out, step, mgr))
    (clean, cstep, _), (bombed, bstep, bmgr) = runs
    assert clean["rollbacks"] == 0 and bombed["rollbacks"] == 1
    events = [e["event"] for e in sup.read_ledger(bmgr.directory)]
    assert events == ["divergence", "rollback", "recovered", "done"]
    assert bombed["losses"][-6:] == clean["losses"][-6:]
    for a, b in zip(bstep._gp, cstep._gp):
        assert torch.equal(a, b)



def test_serve_engine_graph_replay_matches_eager(dev):
    from incubator_mxnet_tpu_torch import context, initializer, random
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.serve import (CachedDecoder, ServeEngine,
                                                 SwapRejected, TinyDecoderLM)

    random.seed(0)
    net = nn.HybridSequential()
    with context.device_scope(dev):
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(3, 2, 1),
                nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(6))
    net.initialize(init=initializer.Xavier())
    net.shape_init((2, 3, 16, 16))
    eng = ServeEngine(net, buckets=(2, 8))
    eng.warmup(np.zeros((3, 16, 16), np.float32))
    assert all(launches.get("maxpool_idx_fwd") == 1
               for launches in eng.capture_launches.values())
    x = np.random.RandomState(0).rand(5, 3, 16, 16).astype(np.float32)
    before = _kernels.launch_counts()
    out = eng.infer(x)
    assert _kernels.launch_counts() == before
    slot = eng._slots[eng._state[1]]
    xp = torch.zeros((8, 3, 16, 16), device=dev)
    xp[:5] = torch.from_numpy(x)
    with torch.no_grad():
        ref = slot.net(xp)[:5]
    assert torch.equal(out, ref)
    mates = np.random.RandomState(1).rand(7, 3, 16, 16).astype(np.float32)
    assert torch.equal(eng.infer(np.concatenate([x[:1], mates]))[0], out[0])
    with pytest.raises(SwapRejected):
        eng.update_params(fi.nan_params(eng))
    assert torch.equal(eng.infer(x), out) and eng.recompile_count == 0

    lm = TinyDecoderLM(vocab=16, d_model=8, n_heads=2, n_layers=1, d_ff=16,
                       max_len=8)
    params = lm.init(2, device=dev)
    dec = CachedDecoder(lm, params, seq_buckets=(8,))
    dec.start(np.array([[1, 2, 3]]), max_new=5)
    feed = [4, 9, 1, 7, 3, 3, 12, 5, 0]
    steps = [dec.step(np.array([t])) for t in feed]
    seq = torch.tensor([[1, 2, 3] + feed], device=dev)
    full = lm.apply_tokens(params, seq, window=8)
    for i, got in enumerate(steps):
        _close(got[0], full[0, 3 + i], 1e-5)
    assert dec.pos == 12 and dec.compiles == 2


def _i8(rs, shape):
    return torch.from_numpy(rs.randint(-127, 128, shape).astype(np.int8))


def _f32s(*vals):
    return [torch.tensor(v, dtype=torch.float32) for v in vals]


def _quant_op_cases():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.uniform(-3, 5, (64, 33)).astype(np.float32))
    acc = torch.from_numpy(rs.randint(-2 ** 20, 2 ** 20, (7, 45))
                           .astype(np.int32))
    cases = {
        "quantize": ("_contrib_quantize", [x] + _f32s(-2.0, 3.0), {}),
        "quantize_v2": ("_contrib_quantize_v2", [x], {}),
        "dequantize": ("_contrib_dequantize", [acc] + _f32s(-3e-3, 3e-3),
                       {}),
        "requantize": ("_contrib_requantize", [acc] + _f32s(-7.5, 7.5), {}),
        "elemwise_add": ("_contrib_quantized_elemwise_add",
                         [_i8(rs, (4, 9, 13)), _i8(rs, (4, 9, 13))]
                         + _f32s(-1.1, 0.9, -0.3, 4.0), {}),
    }
    # the padded _int_mm shapes: rows <= 16, K 147 (the stem), N odd
    for m, k, n in ((3, 147, 5), (16, 16, 16), (40, 64, 1000)):
        cases["fc_%dx%dx%d" % (m, k, n)] = (
            "_contrib_quantized_fully_connected",
            [_i8(rs, (m, k)), _i8(rs, (n, k)), _i8(rs, (n,))]
            + _f32s(-2.0, 2.5, -0.6, 0.5, -1.0, 0.8), dict(num_hidden=n))
    for tag, (c, o, g, k, stride, pad, dil) in {
            "stem": (3, 64, 1, 7, (2, 2), (3, 3), (1, 1)),
            "grouped": (6, 9, 3, 3, (1, 1), (0, 0), (1, 1)),
            "dilated": (4, 4, 2, 3, (2, 1), (1, 2), (2, 3))}.items():
        cases["conv_" + tag] = (
            "_contrib_quantized_conv",
            [_i8(rs, (2, c, 23, 21)), _i8(rs, (o, c // g, k, k)),
             _i8(rs, (o,))] + _f32s(-1.5, 3.0, -0.2, 0.25, -0.5, 0.5),
            dict(kernel=(k, k), stride=stride, pad=pad, dilate=dil,
                 num_filter=o, num_group=g))
    return cases


@pytest.mark.parametrize("case", sorted(_quant_op_cases()))
def test_quantization_ops_on_card_match_cpu(dev, case):
    """The seven int8 ops on the card against the CPU: accumulators and
    codes exact, the float ranges and dequantized values bit for bit
    (every code-deciding division divides by a tensor)."""
    from incubator_mxnet_tpu_torch.ops import registry

    name, inputs, attrs = _quant_op_cases()[case]
    op = registry.OPS[name]
    want = op.fn(*inputs, **attrs)
    got = op.fn(*[t.to(dev) for t in inputs], **attrs)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w), name


def test_int8_serve_bucket_replay_matches_eager(dev):
    """The int8 tier on the card: codes made on the card equal to the
    CPU's, one K3 launch a captured bucket program and none in replays,
    a replay bit-equal to the eager forward (the dequantize prologue
    included), a poisoned swap rolled back with the codes unchanged."""
    from incubator_mxnet_tpu_torch import context, initializer, random
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.ops.quantization import quantize_tensor
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.serve import ServeEngine, SwapRejected

    random.seed(0)
    net = nn.HybridSequential()
    with context.device_scope(dev):
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(3, 2, 1),
                nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(6))
    net.initialize(init=initializer.Xavier())
    net.shape_init((2, 3, 16, 16))
    eng = ServeEngine(net, buckets=(2, 8), dtype="int8")
    eng.warmup(np.zeros((3, 16, 16), np.float32))
    raw = [p.data()._data.detach() for p in eng._params]
    for v, q, a in zip(eng._p_vals, eng._quantized, raw):
        if q:
            codes, amax = quantize_tensor(a.cpu())
            assert torch.equal(v[0].cpu(), codes)
            assert torch.equal(v[1].cpu(), amax)
    assert all(launches.get("maxpool_idx_fwd") == 1
               for launches in eng.capture_launches.values())
    x = np.random.RandomState(0).rand(5, 3, 16, 16).astype(np.float32)
    before = _kernels.launch_counts()
    out = eng.infer(x)
    assert _kernels.launch_counts() == before
    xp = torch.zeros((8, 3, 16, 16), device=dev)
    xp[:5] = torch.from_numpy(x)
    ref = eng._forward(eng._state[1], xp)[:5]
    assert torch.equal(out, ref)
    snap = fi._live_param_snapshot(eng)
    cand = [a.cpu().numpy().copy() for a in raw]
    cand[-1][0] = np.nan            # the dense bias: float, not quantized
    with pytest.raises(SwapRejected):
        eng.update_params(cand)
    after = fi._live_param_snapshot(eng)
    assert all(fi._leaves_equal(a, b) for a, b in zip(snap[1], after[1]))
    assert torch.equal(eng.infer(x), out) and eng.recompile_count == 0


def _record_shard(prefix, n=12, side=20):
    from incubator_mxnet_tpu_torch import recordio

    rng = np.random.RandomState(3)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 5), i, 0),
            rng.randint(0, 255, (side, side, 3), dtype=np.uint8),
            img_fmt=".npy"))
    rec.close()


def test_dataloader_on_card_and_spawned_workers_off_it(dev, tmp_path):
    """``DataLoader`` on the card: the batches of a 0-worker and a thread
    loader equal the CPU loader's bit for bit (the samples are built on
    the host, one upload a batch), and 2 spawned workers give the same
    batches without initializing CUDA."""
    import random

    from incubator_mxnet_tpu_torch.gluon.data import DataLoader
    from incubator_mxnet_tpu_torch.gluon.data.vision import (
        ImageRecordDataset, transforms as T)

    prefix = str(tmp_path / "shard")
    _record_shard(prefix)
    aug = T.Compose([T.RandomResizedCrop(16), T.RandomFlipLeftRight(),
                     T.ToTensor(), T.Normalize(0.5, 0.25)])
    out = {}
    for where in (dev, "cpu"):
        np.random.seed(1)
        random.seed(1)
        ds = ImageRecordDataset(prefix + ".rec").transform_first(aug)
        out[str(where)] = [[t.asnumpy() for t in b] for b in DataLoader(
            ds, batch_size=4, shuffle=True, device=where)]
    for a, b in zip(out[str(dev)], out["cpu"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fixed = ImageRecordDataset(prefix + ".rec").transform_first(
        T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)]))
    batches = {}
    for kw in (dict(num_workers=2), dict(num_workers=2, thread_pool=False)):
        loader = DataLoader(fixed, batch_size=3, device=dev, **kw)
        batches[kw.get("thread_pool", True)] = list(loader)
        cuda = loader.worker_cuda_initialized()
        del loader
    assert batches[True][0][0].context == dev
    for a, b in zip(batches[True], batches[False]):
        for x, y in zip(a, b):
            assert torch.equal(x._data, y._data)
    assert cuda and not any(cuda.values())


def test_deformable_convolution_on_card_matches_cpu(dev):
    """``_contrib_DeformableConvolution`` with 2 deformable groups and
    offsets over the border, forward and the gradients in data, offset,
    weight and bias: card against CPU within 1e-5 of each largest
    magnitude (TF32 off; float sums in another order)."""
    from incubator_mxnet_tpu_torch.ops import registry

    fn = registry.get_op("_contrib_DeformableConvolution").fn
    rng = np.random.RandomState(4)
    arrays = [rng.uniform(-1, 1, (2, 6, 9, 9)),
              rng.uniform(-3, 3, (2, 36, 9, 9)),
              rng.uniform(-1, 1, (5, 6, 3, 3)), rng.uniform(-1, 1, (5,))]
    cot = torch.from_numpy(
        rng.uniform(-1, 1, (2, 5, 9, 9)).astype(np.float32))
    res = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d in (dev, torch.device("cpu")):
            ts = [torch.tensor(a, dtype=torch.float32, device=d,
                               requires_grad=True) for a in arrays]
            y = fn(*ts, kernel=(3, 3), num_filter=5, pad=(1, 1),
                   num_deformable_group=2)
            y.backward(cot.to(d))
            res[d.type] = [y.detach().cpu()] + [t.grad.cpu() for t in ts]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(res["cuda"], res["cpu"]):
        _close(a, b, 1e-5)


def test_estimator_fit_on_card_matches_cpu(dev):
    """``Estimator.fit`` over a ``DataLoader`` on the card and on the
    CPU from the same weights: each batch's loss within 1e-5 (relative)
    and the parameters after 3 batches within 1e-5 of their largest
    magnitude (TF32 off)."""
    from incubator_mxnet_tpu_torch import context, convert, metric
    from incubator_mxnet_tpu_torch.gluon import loss, nn
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as est
    from incubator_mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader

    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (12, 6)).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    weights, runs = None, {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d in (dev, torch.device("cpu")):
            with context.device_scope(d):
                net = nn.HybridSequential()
                net.add(nn.Dense(8, activation="relu", in_units=6),
                        nn.Dense(3, in_units=8))
            net.initialize()
            if weights is None:
                weights = convert.params_to_numpy(net)
            convert.params_from_jax(net, weights)
            losses = []

            class Record(est.BatchEnd):
                def batch_end(self, estimator, *a, loss=None, **kw):
                    losses.append(loss[0].asnumpy().copy())

            e = est.Estimator(net, loss.SoftmaxCrossEntropyLoss(),
                              metrics=metric.Accuracy(), context=d)
            e.fit(DataLoader(ArrayDataset(x, y), batch_size=4, device=d),
                  epochs=1, event_handlers=[Record()])
            runs[d.type] = (losses, convert.params_to_numpy(net))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        _close(torch.from_numpy(a), torch.from_numpy(b), 1e-5)


def test_op_tail_and_nn_layers_on_card_match_cpu(dev):
    """``chip_smoke.py`` phase 3u (iii) at a quarter of its batch: every
    op of the tail and the 23 new ``gluon.nn`` layers, forward and
    backward, card against CPU within 4x the CPU's own difference under
    a 1e-6 nudge (TF32 off), integer outputs equal, ``_eye`` exact and
    ``_linspace`` within one f32 step; no kernel launched."""
    assert _smoke().tail_card_vs_cpu(dev, s=0.25) > 70


def test_amp_step_on_card_matches_cpu(dev):
    """``chip_smoke.py`` phase 3u (i)'s card-against-CPU step at a small
    size: one step of the Gluon example's loop (``resnet18_v1``, 64 px,
    batch 8) under ``amp.init('bfloat16')``: the loss, the logits, the
    running stats and the update's cosine and norm ratio (the whole
    model's and the median tensor's) within 4x the largest of three CPU
    runs' differences under a 1e-6 nudge of the weights; the card's
    update made zero, doubled or negated misses that gate.  (At 32 px a
    1e-6 nudge moves a bf16 update's norm by 20 %, so a doubled update
    would pass.)"""
    smoke = _smoke()
    smoke.amp_card_vs_cpu(dev, **smoke.AMP_SMALL)


def test_amp_float16_overflow_on_card(dev):
    """``chip_smoke.py`` phase 3u (i)'s float16 loss scaler on the card
    (``resnet18_v1``, 64 px, batch 8): a planted inf gradient at the 2^16
    scale skips the step with every parameter bit-equal and halves the
    scale; each later step is applied at its scale when its gradients
    are finite and skipped with the scale halved when not, until one is
    applied."""
    smoke = _smoke()
    log = smoke.amp_overflow_on_card(dev, **smoke.AMP_SMALL)
    assert log[0] == (2.0 ** 16, False, False) and log[-1][2]


def test_np_path_on_card(dev):
    """``chip_smoke.py`` phase 3v (i)-(iii) at a small size
    (``resnet18_v1``, 64 px, batch 8, 10 classes): the ``mx.np``-written
    step launches K3 once a step and nothing else, its first step is bit
    for bit the Gluon net's, ``_multi_adamw_update`` and
    ``_multi_mp_adamw_update`` equal their per-tensor plain versions."""
    smoke = _smoke()
    keep = dict(smoke.NP_PATH)
    smoke.NP_PATH.update(model="resnet18_v1", batch=8, image=64, classes=10,
                         resize=72, raw=(80, 76))
    try:
        metrics, counts = smoke.run_np_path(dev, 1.0)
    finally:
        smoke.NP_PATH.clear()
        smoke.NP_PATH.update(keep)
    assert metrics["bit_equal"] and counts["maxpool_idx_fwd"] == 3


def test_np_step_on_card_matches_cpu(dev):
    """``chip_smoke.py`` phase 3v (iv): the ``mx.np`` step at ``NP_SMALL``
    card against CPU within 4x the largest of three nudged CPU runs'
    differences; the card's update zeroed, doubled or negated misses."""
    smoke = _smoke()
    smoke.np_card_vs_cpu(dev, **smoke.NP_SMALL)


def test_np_surface_on_card_matches_cpu(dev):
    """``chip_smoke.py`` phase 3v (v): every case of
    ``tools/np_surface_cases.py`` card against CPU within 4x the CPU's
    nudged floor (the quiet set equal), the factors rebuilt, the
    samplers' moments on the card."""
    assert _smoke().np_surface_card_vs_cpu(dev) > 300



def test_op_registry_tail_on_card_matches_cpu(dev):
    """``chip_smoke.py`` phase 3w (iv) whole and (iii) at a 200x300
    image: every new name card against CPU, Proposal and MultiProposal
    equal."""
    smoke = _smoke()
    assert smoke.tail_w_card_vs_cpu(dev) > 70
    smoke.RPN.update(image=(200, 300), pre=500, post=50, reps=1)
    smoke.run_proposal(dev)


_CAPTURE_HOST_READ = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import context, gluon, initializer
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.serve import ServeEngine


class HostSqr(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], np.square(np.asarray(in_data[0])))


@mx.operator.register("host_sqr")
class HostSqrProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return HostSqr()


class Net(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = nn.Dense(8, in_units=6)

    def hybrid_forward(self, F, x):
        return F.Custom(self.fc(x), op_type="host_sqr")


with context.device_scope("cuda"):
    net = Net()
initializer.initialize(net, initializer.Xavier())
eng = ServeEngine(net, buckets=(4,))
eng.warmup(np.zeros(6, np.float32))
print("CAPTURED")
"""


def test_custom_op_on_card(dev):
    """``Custom`` on the card: its callbacks get NDArrays on the card;
    eager, recorded and ``Executor`` calls agree (``chip_smoke.py``'s
    ``_custom_card_vs_cpu``).  Under ``ServeEngine``'s CUDA-graph capture
    a ``Custom`` written in nd ops is captured (its Python runs once, at
    capture) and the replay equals the eager forward; one whose callback
    reads to the host (``np.asarray``) cannot be captured: the warmup
    raises (run in a process of its own, so that a failed capture cannot
    disturb the tests after it)."""
    import os
    import subprocess
    import sys

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, gluon, initializer
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.serve import ServeEngine

    smoke = _smoke()
    rows = smoke._custom_card_vs_cpu(mx, dev)
    assert len(rows) == 2
    op_type = smoke._custom_ops(mx)
    seen = []

    class Probe(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(in_data[0].context)
            self.assign(out_data[0], req[0], in_data[0] * 2)

    @mx.operator.register("card_probe")
    class ProbeProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Probe()

    out = mx.nd.Custom(mx.nd.ones((3,), ctx=dev), op_type="card_probe")
    assert seen == [dev] and out.context == dev

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = nn.Dense(8, in_units=6)

        def hybrid_forward(self, F, x):
            return F.Custom(self.fc(x), op_type=op_type)[0]

    with context.device_scope(dev):
        net = Net()
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(net, buckets=(4,))
    eng.warmup(np.zeros(6, np.float32))
    x = np.random.RandomState(0).rand(3, 6).astype(np.float32)
    got = eng.infer(x)
    xp = torch.zeros((4, 6), device=dev)
    xp[:3] = torch.from_numpy(x)
    with torch.no_grad():
        want = eng._slots[eng._state[1]].net(xp)[:3]
    assert torch.equal(got, want)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _CAPTURE_HOST_READ, root],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CAPTURED" not in proc.stdout, \
        proc.stdout + proc.stderr
    print("host-reading Custom under capture: %s"
          % proc.stderr.strip().splitlines()[-1])
