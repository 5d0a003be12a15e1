"""The 3xTF32 split that R2 (``csrc/rtc/mm_kernel.cu``) and K4-K6
(``csrc/flash_attention.cu``) compute with on the tensor cores, emulated
in numpy on the CPU.

Each float32 operand x becomes ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(``cvt.rna.tf32.f32``'s rounding: to nearest, ties away from zero, onto
10 mantissa bits; K4-K6 compute it as this module does, with an integer
add and mask), and a product takes three TF32 passes, ``lo·hi + hi·lo``
then ``hi·hi``; a product of two TF32 values is exact in float32, and the
sums stay float32.  These tests hold that arithmetic, applied to the
kernels' plain versions, to the float32 tolerances ``chip_smoke.py``
phase 2 holds the kernels to: R2 within 1e-4 of max |a @ b|, K4's O
within 1e-4 of its largest magnitude (at least 1) and its LSE within 1e-4,
K5's dQ and K6's dK and dV within 1e-3 of theirs.  One TF32 pass misses
by an order of magnitude more, which is why the kernels take three.  A
bf16 value is exact in TF32 (its lo is 0), so a product of two bf16
inputs (Q Kᵀ, dO Vᵀ) takes one pass and a product of P or dS with one
two.
"""
import importlib

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import rtc

tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.parallel.flash_attention")


def tf32(x):
    """``cvt.rna.tf32.f32`` of a float32 array."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32(a, b, passes=3):
    """``a @ b`` of float32 arrays as the kernels compute it."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                  1 + 2 ** -10], dtype=np.float32)
    # ties go away from zero; below half an ulp rounds down
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + 2 ** -10, 1 + 2 ** -9, 1, -(1 + 2 ** -10),
                           1 + 2 ** -10], dtype=np.float32))
    (hi,), (lo,) = split(np.float32([np.pi]))
    assert hi + lo != hi and abs(float(hi + lo) - np.pi) < 2 ** -20


def test_bf16_values_are_exact_in_tf32():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) \
        .bfloat16().float().numpy()
    hi, lo = split(x)
    np.testing.assert_array_equal(hi, x)
    assert not lo.any()


@pytest.mark.parametrize("m,k,n", [(257, 33, 130), (64, 1024, 96)])
def test_r2_split_keeps_float32_accuracy(m, k, n):
    rng = np.random.RandomState(2)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = rtc.mm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = _rel(matmul_tf32(a, b), want)
    one = _rel(matmul_tf32(a, b, passes=1), want)
    assert three <= 1e-4
    assert _rel(matmul_tf32(a, b), exact) <= 2 * _rel(want, exact) + 1e-6
    assert one > 10 * three


def _tf32_matmul(passes):
    def mm(x, y):
        return torch.from_numpy(matmul_tf32(x.numpy(), y.numpy(), passes))
    return mm


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (2, 128, 128, 64, True),
    (2, 100, 100, 128, False),
    (2, 96, 40, 16, True),
])
def test_k4_split_keeps_float32_accuracy(monkeypatch, bh, sq, sk, d,
                                         causal):
    """``_flash_fwd_plain`` with its two products (S = Q Kᵀ and P V) in
    3xTF32, against itself in float32."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d))
                                .astype(np.float32)) for s in (sq, sk, sk))
    scale = d ** -0.5
    want, want_lse = tfa._flash_fwd_plain(q, k, v, scale, causal, 64, 64)
    results = {}
    for passes in (3, 1):
        monkeypatch.setattr(torch, "matmul", _tf32_matmul(passes))
        results[passes] = tfa._flash_fwd_plain(q, k, v, scale, causal, 64, 64)
        monkeypatch.undo()
    out, lse = results[3]
    seen = want_lse > -5e29
    limit = 1e-4 * max(1.0, want.abs().max().item())
    err = (out - want).abs().max().item()
    lse_err = (lse[seen] - want_lse[seen]).abs().max().item()
    assert err <= limit
    assert lse_err <= 1e-4 * max(1.0, want_lse[seen].abs().max().item())
    assert torch.equal(out[~seen], want[~seen])
    one_err = (results[1][0] - want).abs().max().item()
    assert one_err > 10 * err


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (2, 128, 128, 64, True),
    (2, 100, 100, 128, False),
    (2, 96, 40, 16, True),        # Sq > Sk: 56 rows see no key
])
def test_k5_k6_split_keeps_float32_accuracy(monkeypatch, bh, sq, sk, d,
                                            causal):
    """``_flash_bwd_dq_plain`` and ``_flash_bwd_dkv_plain`` with their
    products (S, dP, then dS K for K5; Pᵀ dO and dSᵀ Q for K6) in 3xTF32,
    against themselves in float32, at the card's gradient tolerance: 1e-3
    of the largest magnitude (at least 1)."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d))
                                    .astype(np.float32))
                   for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    out, lse = tfa._flash_fwd_plain(q, k, v, scale, causal, 64, 64)
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, 64, 64)
    want = (tfa._flash_bwd_dq_plain(*args),) + tfa._flash_bwd_dkv_plain(*args)
    results = {}
    for passes in (3, 1):
        monkeypatch.setattr(torch, "matmul", _tf32_matmul(passes))
        results[passes] = ((tfa._flash_bwd_dq_plain(*args),)
                           + tfa._flash_bwd_dkv_plain(*args))
        monkeypatch.undo()
    empty = lse <= -5e29
    assert torch.equal(results[3][0][empty], torch.zeros_like(want[0][empty]))
    for name, got, one, ref in zip(("dQ", "dK", "dV"), results[3], results[1],
                                   want):
        limit = 1e-3 * max(1.0, ref.abs().max().item())
        err = (got - ref).abs().max().item()
        assert err <= limit, (name, err, limit)
        assert (one - ref).abs().max().item() > 10 * err, name
