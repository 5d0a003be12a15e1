"""The port's flash attention (``incubator_mxnet_tpu_torch/parallel/
flash_attention.py``) against the JAX package's Pallas kernels, on the CPU.

The JAX side runs ``flash_attention(..., use_pallas=True,
interpret=True)``: the Pallas kernels in interpret mode.  The port's side
runs its plain versions (the tensors lie on the CPU).  The cases are those
of ``tests/test_flash_attention.py``: dense, causal, S = 40 (the tile
shrinks to a divisor), a cross length (Sq 4 vs Sk 12), empty rows (Sq 8
vs Sk 4 under causal: O and dQ are 0 there), bf16, and dQ/dK/dV under
both masks; plus the forward's LSE against the JAX ``_fwd`` and the
blocking invariance of the plain version.

Tolerances are the JAX tests': 1e-5 for the forward (f32; both sides sum
the same tiles in f32, in another order), rtol 1e-4 / atol 1e-5 for the
gradients, 5e-2 for bf16 (one bf16 rounding of values up to 1).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.parallel import flash_attention as jflash
from incubator_mxnet_tpu.parallel.ring_attention import \
    attention_reference as jref

from incubator_mxnet_tpu_torch.parallel import flash_attention
from incubator_mxnet_tpu_torch.parallel import ring_attention as tring

tfa = importlib.import_module("incubator_mxnet_tpu_torch.parallel.flash_attention")
jfa = importlib.import_module("incubator_mxnet_tpu.parallel.flash_attention")


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _jax(causal, **blocks):
    return lambda q, k, v: jflash(q, k, v, causal=causal, use_pallas=True,
                                  interpret=True, **blocks)


def _torch(causal, **blocks):
    return lambda q, k, v: flash_attention(q, k, v, causal=causal, **blocks)


# (label, q shape, kv shape, causal, blocks, seed)
CASES = [
    ("dense", (2, 2, 64, 16), (2, 2, 64, 16), False, {}, 0),
    ("causal", (2, 2, 32, 16), (2, 2, 32, 16), True, {}, 0),
    ("seq40", (2, 2, 40, 16), (2, 2, 40, 16), False, {}, 0),
    ("seq40 causal", (2, 2, 40, 16), (2, 2, 40, 16), True,
     dict(block_q=16, block_k=16), 1),
    ("cross length", (1, 2, 4, 8), (1, 2, 12, 8), True,
     dict(block_q=2, block_k=4), 3),
    ("empty rows", (1, 2, 8, 8), (1, 2, 4, 8), True,
     dict(block_q=4, block_k=4), 5),
]


@pytest.mark.parametrize("label,qs,ks,causal,blocks,seed", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_matches_pallas(label, qs, ks, causal, blocks, seed):
    q, k, v = _arrays([qs, ks, ks], seed)
    want = _jax(causal, **blocks)(*map(jnp.asarray, (q, k, v)))
    got = _torch(causal, **blocks)(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("label,qs,ks,causal,blocks,seed", CASES,
                         ids=[c[0] for c in CASES])
def test_grads_match_pallas(label, qs, ks, causal, blocks, seed):
    q, k, v = _arrays([qs, ks, ks], seed)
    (g,) = _arrays([qs], seed + 100)

    def jloss(q, k, v):
        return jnp.sum(_jax(causal, **blocks)(q, k, v) * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = _torch(causal, **blocks)(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg="d%s" % name)


def test_empty_rows_are_zero():
    """Sq 8, Sk 4, causal: rows 0..3 see no key; O and dQ are exactly 0
    there and dK/dV finite (test_flash_attention.py's empty-row case)."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in
               _arrays([(1, 2, 8, 8), (1, 2, 4, 8), (1, 2, 4, 8)], 5))
    out = flash_attention(q, k, v, causal=True, block_q=4, block_k=4)
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    (out ** 2).sum().backward()
    assert torch.equal(q.grad[:, :, :4], torch.zeros_like(q.grad[:, :, :4]))
    assert torch.isfinite(k.grad).all() and torch.isfinite(v.grad).all()
    ref = tring.attention_reference(q.detach(), k.detach(), v.detach(),
                                    causal=True)
    np.testing.assert_allclose(out[:, :, 4:].detach().numpy(),
                               ref[:, :, 4:].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_dense_reference(causal):
    """dQ/dK/dV under both masks against autograd through the port's dense
    ``attention_reference`` and the JAX one (test_flash_grads_match_dense)."""
    q, k, v = _arrays([(2, 2, 32, 16)] * 3, 0)

    def jloss(q, k, v):
        return jnp.sum(jref(q, k, v, causal=causal) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    grads = []
    for fn in (flash_attention, tring.attention_reference):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (fn(*ts, causal=causal) ** 2).sum().backward()
        grads.append([t.grad.numpy() for t in ts])
    for name, gf, gd, gj in zip("qkv", grads[0], grads[1], jgrads):
        np.testing.assert_allclose(gf, gd, rtol=1e-4, atol=1e-5,
                                   err_msg="d%s vs dense" % name)
        np.testing.assert_allclose(gf, np.asarray(gj), rtol=1e-4, atol=1e-5,
                                   err_msg="d%s vs jax dense" % name)


def test_bf16_matches_pallas():
    q, k, v = _arrays([(2, 2, 64, 16)] * 3, 0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = _jax(False)(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)
    ref = jref(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_pallas_fwd(causal):
    """The saved log-sum-exp against the JAX ``_fwd`` (BH, S) output,
    including the ~-1e30 of empty rows."""
    q, k, v = _arrays([(4, 24, 8), (4, 16, 8), (4, 16, 8)], 7)
    scale = float(1.0 / np.sqrt(8))   # a numpy f64 would promote under x64
    jout, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale, causal, 8, 8, True)
    out, lse = tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), scale, causal, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    if causal:
        assert (lse[:, :8] < -5e29).all() and (lse[:, 8:] > -1e3).all()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_blocking_invariance(causal):
    """Different tilings of the plain versions give the same forward and
    backward (the streaming softmax does not depend on the tile)."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays([(4, 48, 16)] * 4, 2))
    scale = 0.25
    res = []
    for bq, bk in ((16, 16), (48, 48), (8, 24)):
        out, lse = tfa._flash_fwd_plain(q, k, v, scale, causal, bq, bk)
        delta = (do * out).sum(-1)
        res.append((out, lse) + tfa._flash_bwd_plain(q, k, v, do, lse, delta,
                                                     scale, causal, bq, bk))
    for other in res[1:]:
        for a, b in zip(res[0], other):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_default_blocks_follow_reference(monkeypatch):
    """128 x 128 by default, 256 x 512 from Sk >= 4096, explicit sizes win
    (test_flash_attention_long_seq_block_heuristic)."""
    picked = []
    orig = tfa._flash_fwd_plain

    def spy(q, k, v, scale, causal, bq, bk):
        picked.append((bq, bk))
        return orig(q, k, v, scale, causal, bq, bk)

    monkeypatch.setattr(tfa, "_flash_fwd_plain", spy)
    for sk, blocks, want in ((64, {}, (128, 128)),
                             (4096, {}, (256, 512)),
                             (4096, dict(block_q=128, block_k=128),
                              (128, 128))):
        q = torch.zeros(1, 1, 8, 8)
        kv = torch.zeros(1, 1, sk, 8)
        flash_attention(q, kv, kv, **blocks)
        assert picked[-1] == want


def test_block_update_matches_reference():
    """``_block_attn_update`` over two K/V halves with a causal mask equals
    the JAX one and, normalised, the dense reference."""
    from incubator_mxnet_tpu.parallel import ring_attention as jring

    q, k, v = _arrays([(1, 2, 8, 8)] * 3, 4)
    scale = float(1.0 / np.sqrt(8))
    rows = np.arange(8)[:, None]
    state_j = (jnp.full((1, 2, 8), -jnp.inf, jnp.float32),
               jnp.zeros((1, 2, 8), jnp.float32),
               jnp.zeros((1, 2, 8, 8), jnp.float32))
    state_t = (torch.full((1, 2, 8), float("-inf")), torch.zeros(1, 2, 8),
               torch.zeros(1, 2, 8, 8))
    for lo in (0, 4):
        mask = (lo + np.arange(4))[None, :] <= rows
        state_j = jring._block_attn_update(
            jnp.asarray(q), jnp.asarray(k[:, :, lo:lo + 4]),
            jnp.asarray(v[:, :, lo:lo + 4]), *state_j, scale,
            jnp.asarray(mask)[None, None])
        state_t = tring._block_attn_update(
            torch.from_numpy(q), torch.from_numpy(k[:, :, lo:lo + 4]),
            torch.from_numpy(v[:, :, lo:lo + 4]), *state_t, scale,
            torch.from_numpy(mask)[None, None])
    for a, b in zip(state_t, state_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    out = state_t[2] / state_t[1][..., None]
    ref = tring.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_bad_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(q.double(), q.double(), q.double(), 1.0, False)
    with pytest.raises(TypeError, match="k is"):
        tfa.flash_fwd(q, q.bfloat16(), q, 1.0, False)
    with pytest.raises(ValueError, match="k and v"):
        tfa.flash_fwd(q, torch.zeros(2, 8, 8), q, 1.0, False)
    with pytest.raises(ValueError, match="lse must be float32"):
        tfa.flash_bwd_dq(q, q, q, q, torch.zeros(2, 7), torch.zeros(2, 8),
                         1.0, False)
