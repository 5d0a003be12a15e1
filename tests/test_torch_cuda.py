"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they build the kernels with ``nvcc`` and run on an H100,
and skip where there is no card.  Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's host need not
have).  Small shapes; the full-size checks are in ``chip_smoke.py``.

Tolerances: f32 outputs 1e-4 of the reference's largest magnitude (sums
in another order); bf16 outputs 2^-7 of it (one rounding of a value the
two sides compute in f32 may land one bf16 step apart); the f32 sums
dgamma and dbeta 1e-3 of it.  Max pooling is exact.  Flash attention
(K4-K6): O and LSE 1e-4 in f32 and 2^-7 in bf16, dQ/dK/dV 1e-3 in f32
(sums over every key or query) and 2^-6 in bf16; rows that see no key
exactly 0 in O and dQ; head dims off the kernels' grid (zero-padded to
a multiple of 8) as the rest.  K7 (``bn_copy``) and R1
(``scale_kernel``) exact; R2 (``mm_kernel``) 1e-4 of max |a @ b| (f32 sums in another order
than cuBLAS's); the nd attention layer card against CPU 1e-4 relative.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.clamp_min(torch.round(torch.randn(8, 64, 56, 56, generator=g,
                                                device=dev) * 2) / 2, 0)
    x = x.to(dtype)
    cfg = ((1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
    out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
    outp, idxp = maxpool_idx._maxpool_plain(x, *cfg)
    torch.cuda.synchronize()
    assert torch.equal(out, outp)
    assert torch.equal(idx, idxp)


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


def test_cuda_wrappers_refuse_bad_inputs(dev):
    x = torch.zeros(4, 8, 3, 3, device=dev)
    g = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bn.ghost_bn_fwd(x.transpose(2, 3), g, g, None, 1e-5, "relu", 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_bn.ghost_bn_fwd(x, g.bfloat16(), g, None, 1e-5, "relu", 2)
    with pytest.raises(ValueError, match="on cuda"):
        fused_bn.ghost_bn_fwd(x, g.cpu(), g, None, 1e-5, "relu", 2)
    with pytest.raises(ValueError, match="contiguous"):
        maxpool_idx.maxpool_with_index(
            x.transpose(2, 3), (1, 1, 2, 2), (1, 1, 2, 2),
            ((0, 0), (0, 0), (0, 0), (0, 0)))
    q = torch.zeros(2, 16, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2), q,
                     1.0, False)
    big = torch.zeros(2, 16, 136, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(big, big, big, 1.0, False)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(big[None], big[None], big[None])
    # more than 65535 row tiles of 128 along the grid's y (checked before
    # the layout: the expanded tensor costs 32 bytes)
    long = torch.zeros(1, 1, 8, device=dev).expand(1, 65535 * 128 + 1, 8)
    with pytest.raises(ValueError, match="65535 tiles"):
        fa.flash_fwd(long, long, long, 1.0, False)
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
