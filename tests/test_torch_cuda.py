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
exactly 0 in O and dQ.
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
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(q[..., :60].contiguous(), q[..., :60].contiguous(),
                     q[..., :60].contiguous(), 1.0, False)
    big = torch.zeros(2, 16, 136, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(big, big, big, 1.0, False)
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
