"""Flash attention at head dims the CUDA kernels do not take, and the
kernels' grid limits, on the CPU.

K4-K6 take D <= 128 with D % 8 == 0.  The card's wrappers route other head
dims by shape: D <= 128 is zero-padded along D to the next multiple of 8
and the outputs sliced back; D > 128 is refused (no kernel takes it, and
a CUDA tensor never falls back to the plain version).  Here the wrappers
are told the tensors are on the card and the launches are replaced by
their plain versions (or by a recorder, as the R2 geometry test does),
so the routing runs on CPU tensors.  b*h is the grid's x (up to 2^31 - 1);
the row tiles of 128 are its y, at most 65535.

Tolerances: padding is exact (bit for bit against the unpadded plain
version: the zero columns add exact zeros); the port against the JAX
Pallas kernels (interpret mode) as in ``test_torch_flash_attention.py``,
1e-5 for the forward and rtol 1e-4 / atol 1e-5 for the gradients in f32.
"""
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.parallel import flash_attention as jflash

from incubator_mxnet_tpu_torch import _kernels
from incubator_mxnet_tpu_torch.parallel import flash_attention

tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.parallel.flash_attention")
SOURCE = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc",
                      "flash_attention.cu")


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
            for s in shapes]


def _on_card(monkeypatch):
    """The wrappers take CPU tensors down their card branch."""
    monkeypatch.setattr(tfa, "_on_card", lambda t: True)


def _plain_launches(monkeypatch):
    """The card branch, with the three launches sent to the plain versions;
    returns the list of (kernel, D) each launch was handed."""
    _on_card(monkeypatch)
    seen = []

    def fwd(q, k, v, scale, causal):
        seen.append(("fwd", q.shape[-1]))
        return tfa._flash_fwd_plain(q, k, v, scale, causal)

    def dq(q, k, v, do, lse, delta, scale, causal):
        seen.append(("dq", q.shape[-1]))
        return tfa._flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)

    def dkv(q, k, v, do, lse, delta, scale, causal):
        seen.append(("dkv", q.shape[-1]))
        return tfa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale,
                                        causal)

    monkeypatch.setattr(tfa, "_launch_fwd", fwd)
    monkeypatch.setattr(tfa, "_launch_bwd_dq", dq)
    monkeypatch.setattr(tfa, "_launch_bwd_dkv", dkv)
    return seen


class _FakeKernel:
    """Records what a wrapper hands ``Kernel.launch``."""

    def __init__(self):
        self.calls = []
        self.launches = 0

    def launch(self, device, *args):
        self.calls.append(args)


def _fake_kernels(monkeypatch):
    _on_card(monkeypatch)
    fakes = {}
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        fakes[name] = _FakeKernel()
        monkeypatch.setitem(_kernels.KERNELS, name, fakes[name])
    return fakes


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,dp", [(4, 8), (20, 24)])
def test_padding_is_exact(monkeypatch, d, dp, causal):
    """Zero-padding D to a multiple of 8 and slicing back gives the
    unpadded plain version's O, LSE, dQ, dK and dV bit for bit."""
    seen = _plain_launches(monkeypatch)
    q, k, v, do = _arrays([(3, 40, d), (3, 56, d), (3, 56, d), (3, 40, d)],
                          d)
    scale = d ** -0.5
    out, lse = tfa.flash_fwd(q, k, v, scale, causal)
    want_out, want_lse = tfa._flash_fwd_plain(q, k, v, scale, causal)
    delta = (do * want_out).sum(-1)
    dq = tfa.flash_bwd_dq(q, k, v, do, want_lse, delta, scale, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, want_lse, delta, scale, causal)
    want = tfa._flash_bwd_plain(q, k, v, do, want_lse, delta, scale, causal)
    assert seen == [("fwd", dp), ("dq", dp), ("dkv", dp)]
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    for got, ref in zip((dq, dk, dv), want):
        assert got.shape == ref.shape and got.is_contiguous()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("card", [True, False])
def test_autograd_pads_once_per_call(monkeypatch, card):
    """On the card flash_attention pads q, k, v once: the forward and both
    backward calls get the same padded tensors, and dO is padded to match.
    On the CPU the plain version gets them as they are."""
    if card:
        seen = _plain_launches(monkeypatch)
    handed = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        orig = getattr(tfa, name)

        def spy(q, k, v, *rest, _orig=orig, _name=name):
            do = rest[0] if torch.is_tensor(rest[0]) else None
            handed.append((_name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           q.shape[-1], None if do is None else do.shape[-1]))
            return _orig(q, k, v, *rest)

        monkeypatch.setattr(tfa, name, spy)
    q, k, v = (t.requires_grad_() for t in _arrays([(1, 2, 24, 20)] * 3, 1))
    out = flash_attention(q, k, v, causal=True)
    assert out.shape == (1, 2, 24, 20)
    out.sum().backward()
    dp = 24 if card else 20
    assert [h[0] for h in handed] == ["flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv"]
    assert len({h[1:4] for h in handed}) == 1
    assert {h[4] for h in handed} == {dp}          # q padded on the card
    assert [h[5] for h in handed[1:]] == [dp, dp]  # dO padded to match
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    if card:
        assert seen == [("fwd", 24), ("dq", 24), ("dkv", 24)]


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_20_matches_pallas(causal):
    """The port at D = 20 (padded to 24 inside flash_attention) against
    the JAX Pallas kernels in interpret mode: forward and gradients."""
    q, k, v = (t.numpy() for t in _arrays([(2, 2, 32, 20)] * 3, 2))
    (g,) = (t.numpy() for t in _arrays([(2, 2, 32, 20)], 3))

    def jfn(q, k, v):
        return jflash(q, k, v, causal=causal, use_pallas=True, interpret=True)

    want = jfn(*map(jnp.asarray, (q, k, v)))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * g),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(g))
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg="d%s" % name)


def test_head_dim_over_128_is_refused_on_the_card(monkeypatch):
    """D = 136 and 256: each wrapper raises before any launch on the card,
    and flash_attention with it; the CPU path computes them."""
    cpu_attention = flash_attention
    fakes = _fake_kernels(monkeypatch)
    for d in (136, 256):
        q, k, v, do = _arrays([(2, 24, d)] * 4, 4)
        lse = torch.zeros(2, 24)
        with pytest.raises(ValueError, match="head dims <= 128"):
            tfa.flash_fwd(q, k, v, 0.0625, True)
        with pytest.raises(ValueError, match="head dims <= 128"):
            tfa.flash_bwd_dq(q, k, v, do, lse, lse, 0.0625, True)
        with pytest.raises(ValueError, match="head dims <= 128"):
            tfa.flash_bwd_dkv(q, k, v, do, lse, lse, 0.0625, True)
        with pytest.raises(ValueError, match="head dims <= 128"):
            flash_attention(q[None], k[None], v[None], causal=True)
    assert all(not f.calls for f in fakes.values())
    monkeypatch.undo()
    q, k, v = (t.requires_grad_() for t in _arrays([(1, 2, 24, 256)] * 3, 5))
    out = cpu_attention(q, k, v, causal=True)
    out.sum().backward()
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_many_heads_pass_and_too_many_row_tiles_are_refused(monkeypatch):
    """b*h = 70000 reaches the launches (it is the grid's x); more than
    65535 row tiles of 128 (the grid's y) are refused before any launch,
    for K4 and K5 by Sq and for K6 by Sk."""
    fakes = _fake_kernels(monkeypatch)
    bh, s, d = 70000, 16, 8
    q = torch.zeros(bh, s, d)
    lse = torch.zeros(bh, s)
    tfa.flash_fwd(q, q, q, 1.0, True)
    tfa.flash_bwd_dq(q, q, q, q, lse, lse, 1.0, True)
    tfa.flash_bwd_dkv(q, q, q, q, lse, lse, 1.0, True)
    # (dtype, q, k, v, out, lse, BH, Sq, Sk, D, ...) and the backward's
    # (dtype, q, k, v, do, lse, delta, dq[, dv], BH, Sq, Sk, D, ...)
    assert fakes["flash_attn_fwd"].calls[0][6:10] == (bh, s, s, d)
    assert fakes["flash_attn_bwd_dq"].calls[0][8:12] == (bh, s, s, d)
    assert fakes["flash_attn_bwd_dkv"].calls[0][9:13] == (bh, s, s, d)

    rows = tfa._BLOCK_ROWS * tfa._MAX_GRID_Y
    one = torch.zeros(1, 1, 8)
    short = torch.zeros(1, 16, 8)
    for n in (rows, rows + 1):
        long = one.expand(1, n, 8)          # no memory behind the rows
        ll = torch.zeros(1, 1).expand(1, n)
        refused = "65535 tiles" if n > rows else "contiguous"
        with pytest.raises(ValueError, match=refused):
            tfa.flash_fwd(long, short, short, 1.0, False)
        with pytest.raises(ValueError, match=refused):
            tfa.flash_bwd_dq(long, short, short, long, ll, ll, 1.0, False)
        with pytest.raises(ValueError, match=refused):
            tfa.flash_bwd_dkv(short, long, long, short, lse[:1], lse[:1],
                              1.0, False)
    assert all(len(f.calls) == 1 for f in fakes.values())


def test_limits_match_the_source():
    """The wrapper's tile rows are the kernels' kBQ4 and kBR, and the C
    entries check the tile count, not b*h, against 65535."""
    src = open(SOURCE).read()
    consts = dict(re.findall(r"constexpr int (kBQ4|kBR) = (\d+);", src))
    assert int(consts["kBQ4"]) == int(consts["kBR"]) == tfa._BLOCK_ROWS
    assert tfa._MAX_GRID_Y == 65535 and "tiles > 65535" in src
    assert "BH > 65535" not in src
    for entry, tiles in (("flash_attn_fwd", "(Sq - 1) / kBQ4 + 1"),
                         ("flash_attn_bwd_dq", "(Sq - 1) / kBR + 1"),
                         ("flash_attn_bwd_dkv", "(Sk - 1) / kBR + 1")):
        body = src[src.index('extern "C" int %s(' % entry):]
        assert body.index("bad_shape(BH, Sq, Sk, D, %s)" % tiles) < \
            body.index("return dtype == 0")
