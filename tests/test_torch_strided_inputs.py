"""Strided inputs on the card's branch of the kernel wrappers, on the CPU.

JAX arrays have no strides, so the reference computes flash attention of
a slice of a wider tensor, and a max pool or ghost BN of a permuted or
``channels_last`` tensor.  The port's card wrappers copy such an input
once into a fresh contiguous tensor and launch the kernel on that copy;
a contiguous input costs no copy.  Here the wrappers are told the tensors
are on the card (``_on_card``) and the launches go to a recorder, so the
routing runs on CPU tensors: each call launches its kernel once, and the
pointer it hands the kernel is that of the one contiguous copy its
wrapper made (or of the input itself where none was needed).
"""
import importlib

import pytest
import torch

from incubator_mxnet_tpu_torch import _kernels
from incubator_mxnet_tpu_torch.parallel import fused_bn, maxpool_idx

fa = importlib.import_module(
    "incubator_mxnet_tpu_torch.parallel.flash_attention")


class _Recorder:
    """Records what a wrapper hands ``Kernel.launch``."""

    def __init__(self):
        self.calls = []
        self.launches = 0

    def launch(self, device, *args):
        self.calls.append(args)


def _card(monkeypatch, module, names):
    """``module``'s wrappers take CPU tensors down their card branch, the
    kernels ``names`` launch into recorders."""
    monkeypatch.setattr(module, "_on_card", lambda t: True)
    rec = {}
    for name in names:
        rec[name] = _Recorder()
        monkeypatch.setitem(_kernels.KERNELS, name, rec[name])
    return rec


def _copy_spy(monkeypatch, module, name):
    """Wraps ``module.<name>`` (the wrapper's copy helper): a list of
    (input, output) for every call that returned a new tensor."""
    copies = []
    orig = getattr(module, name)

    def spy(t, *rest):
        out = orig(t, *rest)
        if out is not None and out is not t:
            copies.append((t, out))
        return out

    monkeypatch.setattr(module, name, spy)
    return copies


def _layout(kind, shape, seed, last=None):
    """A float32 tensor of ``shape``: contiguous, a slice of a wider one
    along the last axis, or a permutation of a contiguous one (the last
    axis moved first)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "contiguous":
        return torch.randn(*shape, generator=g)
    if kind == "sliced":
        wide = torch.randn(*shape[:-1], shape[-1] + (last or 24),
                           generator=g)
        return wide[..., :shape[-1]]
    base = torch.randn(shape[-1], *shape[:-1], generator=g)
    return base.permute(*range(1, len(shape)), 0)


@pytest.mark.parametrize("kind", ["contiguous", "sliced", "permuted"])
def test_flash_strided_inputs_take_one_copy(monkeypatch, kind):
    """K4, K5 and K6: q, k and dO in ``kind``'s layout, v contiguous;
    each launch gets the one contiguous copy of each strided input
    (none of v), lse and delta as they are."""
    rec = _card(monkeypatch, fa, ("flash_attn_fwd", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv"))
    copies = _copy_spy(monkeypatch, fa, "_pad")
    q = _layout(kind, (2, 40, 64), 1)
    k = _layout(kind, (2, 56, 64), 2)
    v = _layout("contiguous", (2, 56, 64), 3)
    do = _layout(kind, (2, 40, 64), 4)
    lse = delta = torch.zeros(2, 40)
    fa.flash_fwd(q, k, v, 0.125, True)
    fa.flash_bwd_dq(q, k, v, do, lse, delta, 0.125, True)
    fa.flash_bwd_dkv(q, k, v, do, lse, delta, 0.125, True)
    assert [len(r.calls) for r in rec.values()] == [1, 1, 1]
    strided = kind != "contiguous"
    # q, k once a call (three calls) and dO once in each backward call
    assert len(copies) == (8 if strided else 0)
    for src, out in copies:
        assert src is not v and out.is_contiguous()
        assert out.data_ptr() % 16 == 0 and torch.equal(out, src)
    made = {out.data_ptr() for _, out in copies}
    (fwd,), (dq,), (dkv,) = (r.calls for r in rec.values())
    # (dtype, q, k, v, ...) and (dtype, q, k, v, do, lse, delta, ...)
    for args in (fwd, dq, dkv):
        assert (args[1] in made, args[2] in made) == (strided, strided)
        assert args[3] == v.data_ptr()
    for args in (dq, dkv):
        assert (args[4] in made) == strided
        assert args[5:7] == (lse.data_ptr(), delta.data_ptr())


@pytest.mark.parametrize("kind", ["contiguous", "sliced", "permuted"])
def test_flash_attention_copies_once_per_call(monkeypatch, kind):
    """The public function on strided q, k, v and a strided cotangent:
    each copied once for the whole call (the forward and both backward
    launches get the same copies), one launch of each kernel."""
    rec = _card(monkeypatch, fa, ("flash_attn_fwd", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv"))
    copies = _copy_spy(monkeypatch, fa, "_pad")
    q, k, v = (_layout(kind, (1, 2, 40, 32), s).requires_grad_()
               for s in (5, 6, 7))
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(_layout(kind, (1, 2, 40, 32), 8))
    assert [len(r.calls) for r in rec.values()] == [1, 1, 1]
    assert len(copies) == (4 if kind != "contiguous" else 0)
    assert len({r.calls[0][1] for r in rec.values()}) == 1
    assert all(out.is_contiguous() for _, out in copies)


@pytest.mark.parametrize("kind", ["contiguous", "sliced", "permuted"])
def test_maxpool_strided_input_takes_one_copy(monkeypatch, kind):
    """K3 on a plane sliced along W or a permuted (NHWC-major) tensor:
    one contiguous copy, one launch on it; none for contiguous NCHW."""
    rec = _card(monkeypatch, maxpool_idx, ("maxpool_idx_fwd",))
    copies = _copy_spy(monkeypatch, maxpool_idx, "_dense")
    x = _layout(kind, (2, 8, 20, 20), 9)
    cfg = ((1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
    out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
    assert out.shape == idx.shape == (2, 8, 10, 10) and out.is_contiguous()
    (args,) = rec["maxpool_idx_fwd"].calls
    if kind == "contiguous":
        assert not copies and args[1] == x.data_ptr()
    else:
        ((src, dense),) = copies
        assert src is x and dense.is_contiguous() and torch.equal(dense, x)
        assert args[1] == dense.data_ptr()
    # (dtype, x, out, idx, N, C, H, W, OH, OW, ...)
    assert args[4:10] == (2, 8, 20, 20, 10, 10)


@pytest.mark.parametrize("kind", ["contiguous", "channels_last", "permuted"])
def test_ghost_bn_strided_inputs_take_one_copy(monkeypatch, kind):
    """K1 and K2 on a ``channels_last`` x or a permuted x (and cotangent):
    each NCHW operand copied once into contiguous NCHW, one launch each;
    the f32 per-channel vectors go as they are."""
    rec = _card(monkeypatch, fused_bn, ("ghost_bn_fwd", "ghost_bn_bwd"))
    copies = _copy_spy(monkeypatch, fused_bn, "_dense")
    shape = (4, 16, 6, 6)
    if kind == "channels_last":
        x = torch.randn(*shape).to(memory_format=torch.channels_last)
        gy = torch.randn(*shape).to(memory_format=torch.channels_last)
    else:
        x = _layout(kind, shape, 10)
        gy = _layout(kind, shape, 11)
    gamma, beta = torch.ones(16), torch.zeros(16)
    y, m, v = fused_bn.ghost_bn_fwd(x, gamma, beta, None, 1e-5, "relu", 2)
    assert y.is_contiguous() and m.shape == (2, 16)
    fused_bn.ghost_bn_bwd(gy, None, x, None, gamma, beta, m, v, 1e-5,
                          "relu", 2)
    (fwd,), (bwd,) = rec["ghost_bn_fwd"].calls, rec["ghost_bn_bwd"].calls
    made = {out.data_ptr() for _, out in copies}
    if kind == "contiguous":
        assert not copies
        assert (fwd[1], bwd[1], bwd[3]) == (x.data_ptr(), gy.data_ptr(),
                                            x.data_ptr())
    else:
        # x in the forward; gy and x in the backward
        assert len(copies) == 3
        assert all(out.is_contiguous() and torch.equal(out, src)
                   for src, out in copies)
        assert {fwd[1], bwd[1], bwd[3]} <= made
    # (dtype, x, r, gamma, beta, ...): the vectors are not copied
    assert (fwd[3], fwd[4]) == (gamma.data_ptr(), beta.data_ptr())
