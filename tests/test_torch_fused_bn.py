"""The port's ghost BN (``incubator_mxnet_tpu_torch/parallel/fused_bn.py``)
against the JAX package's ``ghost_bn_act``, on the CPU.

Same numpy inputs on both sides; the JAX side runs its Pallas kernels in
interpret mode (or its jnp fallback where its plan places none), the
port's CPU path runs the plain versions of K1 and K2.  Forward: y and
the (G, C) group mean and variance.  Backward: dx, dgamma, dbeta and the
residual's gradient dR for the same random cotangents (two of them for a
dual exit).  Tolerances (f32, sums in another order): 1e-5 absolute for
y, mean and var, 1e-4 absolute for the gradients.

``ghost_group`` is held to the reference plan's group at all 53 BN
layers of ResNet-50 at 224 px, batch 256 and 128, bf16 and f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.parallel import fused_bn as jfb

from incubator_mxnet_tpu_torch.ops import nn as tops
from incubator_mxnet_tpu_torch.parallel import fused_bn as tfb

# (shape, group cap, act, residual, donate, dual)
CASES = [
    # C >= 128: the reference's channels-on-lanes kernels, group 4 of 8
    ((8, 128, 4, 4), 4, "relu", False, False, False),
    ((8, 128, 4, 4), 4, "none", False, False, False),
    ((8, 128, 4, 4), 4, "relu", True, False, False),
    ((8, 128, 4, 4), 4, "relu", True, False, True),
    ((8, 128, 4, 4), 4, "relu", True, True, True),
    ((8, 128, 4, 4), 4, "relu", True, True, False),
    # C < 128, N <= 128: the reference's whole-batch kernel (group = N)
    ((8, 32, 6, 6), 0, "relu", False, False, False),
    ((8, 32, 6, 6), 0, "none", False, False, False),
    ((8, 32, 6, 6), 0, "relu", True, False, True),
    # C < 128 with a cap below N: the reference's jnp fallback, group 4
    ((8, 32, 6, 6), 4, "relu", False, False, False),
    ((8, 32, 6, 6), 4, "relu", True, True, True),
    # a cap that is no divisor: stepped down to 3 of 6
    ((6, 16, 5, 5), 4, "relu", False, False, False),
]


def _inputs(shape, residual, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.normal(size=c) * 0.2).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32) if residual else None
    gy = rng.normal(size=shape).astype(np.float32)
    gy2 = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, r, gy, gy2


def _jax_side(x, gamma, beta, r, gy, gy2, group, act, donate, dual):
    kw = dict(eps=1e-5, act=act, group=group, donate_residual=donate,
              dual_out=dual)
    outs = jfb.ghost_bn_act(jnp.asarray(x), jnp.asarray(gamma),
                            jnp.asarray(beta),
                            None if r is None else jnp.asarray(r), **kw)
    y, m, v = outs[0], outs[-2], outs[-1]

    def f(x_, g_, b_, r_):
        o = jfb.ghost_bn_act(x_, g_, b_, r_, **kw)
        return o[:2] if dual else o[0]

    args = [jnp.asarray(a) for a in (x, gamma, beta)]
    args.append(None if r is None else jnp.asarray(r))
    _, vjp = jax.vjp(f, *args)
    ct = (jnp.asarray(gy), jnp.asarray(gy2)) if dual else jnp.asarray(gy)
    grads = vjp(ct)
    return [np.asarray(a) for a in (y, m, v)], \
        [None if g is None else np.asarray(g) for g in grads]


def _port_side(x, gamma, beta, r, gy, gy2, group, act, donate, dual):
    xt = torch.tensor(x, requires_grad=True)
    gt = torch.tensor(gamma, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    rt = None if r is None else torch.tensor(r, requires_grad=True)
    outs = tfb.ghost_bn_act(xt, gt, bt, rt, eps=1e-5, act=act, group=group,
                            donate_residual=donate, dual_out=dual)
    y, m, v = outs[0], outs[-2], outs[-1]
    assert not m.requires_grad and not v.requires_grad
    cts = [torch.from_numpy(gy)] + ([torch.from_numpy(gy2)] if dual else [])
    torch.autograd.backward(list(outs[:len(cts)]), cts)
    fwd = [t.detach().numpy() for t in (y, m, v)]
    grads = [xt.grad.numpy(), gt.grad.numpy(), bt.grad.numpy(),
             None if rt is None else rt.grad.numpy()]
    return fwd, grads


@pytest.mark.parametrize("shape,group,act,residual,donate,dual", CASES)
def test_ghost_bn_matches_reference(shape, group, act, residual, donate,
                                    dual):
    inputs = _inputs(shape, residual)
    cfg = (group, act, donate and residual, dual)
    (jy, jm, jv), jg = _jax_side(*inputs, *cfg)
    (ty, tm, tv), tg = _port_side(*inputs, *cfg)
    assert tm.shape == jm.shape          # same number of ghost groups
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dR"), tg, jg):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)


def test_dual_cotangents_stay_apart(monkeypatch):
    """The dual exit's two outputs are distinct autograd outputs: with
    one cotangent on each, K2's plain version receives both and sums
    them (a zero second cotangent would mean autograd merged them)."""
    x, gamma, beta, r, gy, gy2 = _inputs((4, 8, 3, 3), True, seed=2)
    seen = []
    orig = tfb.ghost_bn_bwd

    def spy(gy_, gy2_, *a, **k):
        seen.append((gy_.clone(), None if gy2_ is None else gy2_.clone()))
        return orig(gy_, gy2_, *a, **k)

    monkeypatch.setattr(tfb, "ghost_bn_bwd", spy)
    xt = torch.tensor(x, requires_grad=True)
    y, y_sc, _, _ = tfb.ghost_bn_act(
        xt, torch.tensor(gamma), torch.tensor(beta), torch.tensor(r),
        eps=1e-5, dual_out=True)
    assert y_sc is not y
    torch.autograd.backward([y, y_sc], [torch.from_numpy(gy),
                                        torch.from_numpy(gy2)])
    (g1, g2), = seen
    assert torch.equal(g1, torch.from_numpy(gy))
    assert torch.equal(g2, torch.from_numpy(gy2))


def test_stats_merge_matches_reference():
    rng = np.random.RandomState(3)
    m = rng.normal(size=(4, 16)).astype(np.float32)
    v = rng.uniform(0.1, 2.0, size=(4, 16)).astype(np.float32)
    jbm, jbv = jfb.ghost_bn_stats_merge(jnp.asarray(m), jnp.asarray(v))
    tbm, tbv = tfb.ghost_bn_stats_merge(torch.from_numpy(m),
                                        torch.from_numpy(v))
    np.testing.assert_allclose(tbm.numpy(), np.asarray(jbm), atol=1e-6)
    np.testing.assert_allclose(tbv.numpy(), np.asarray(jbv), atol=1e-6)


def test_aux_update_matches_reference():
    from incubator_mxnet_tpu.ops import nn as jops

    rng = np.random.RandomState(4)
    om, ov, bm, bv = (rng.uniform(0.1, 2, 8).astype(np.float32)
                      for _ in range(4))
    upd = jops._ghost_bn_aux_update(
        [None, None, None, jnp.asarray(om), jnp.asarray(ov)],
        [None, jnp.asarray(bm), jnp.asarray(bv)], momentum=0.9)
    tm, tv = tops.ghost_bn_aux_update(*(torch.from_numpy(a)
                                        for a in (om, ov, bm, bv)), 0.9)
    np.testing.assert_allclose(tm.numpy(), np.asarray(upd[3]), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(upd[4]), atol=1e-6)


def resnet50_bn_layers(n):
    """``(shape, has_res, donate, dual)`` of the 53 ghost-BN layers of
    ``resnet50_v1(ghost_bn=...)`` at 224 px, in network order."""
    layers = [((n, 64, 112, 112), False, False, False)]
    spatial = 56
    for stage, (blocks, ch) in enumerate(zip([3, 4, 6, 3],
                                             [256, 512, 1024, 2048])):
        sp = spatial if stage == 0 else spatial // 2
        for b in range(blocks):
            mid = (n, ch // 4, sp, sp)
            layers += [(mid, False, False, False)] * 2
            if b == 0:                                   # downsample BN
                layers.append(((n, ch, sp, sp), False, False, False))
            dual = not (stage == 3 and b == blocks - 1)
            layers.append(((n, ch, sp, sp), True, b == 0, dual))
        spatial = sp
    return layers


def _reference_group(shape, itemsize, group, has_res, donate, dual):
    d = jfb.plan_describe(*shape, itemsize=itemsize, group=group,
                          has_res=has_res, donate_res=donate, dual=dual)
    if d["variant"] != "jnp":
        return d["group"]
    # no kernel plan: _gbn_ref's rule
    n = shape[0]
    ng = min(n, group or 32)
    while n % ng:
        ng -= 1
    return ng


@pytest.mark.parametrize("n", [256, 128])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_ghost_group_matches_reference_plan_resnet50(n, itemsize):
    layers = resnet50_bn_layers(n)
    assert len(layers) == 53
    picked = []
    for shape, has_res, donate, dual in layers:
        want = _reference_group(shape, itemsize, 16, has_res, donate, dual)
        got = tfb.ghost_group(*shape, itemsize, 16, has_res, donate, dual)
        assert got == want, (shape, has_res, donate, dual)
        picked.append(got)
    if n == 256 and itemsize == 2:
        assert set(picked) == {16}       # the bench: group 16 everywhere


def test_ghost_group_f32_vmem_artefact():
    """At batch 256 in f32 the TPU's VMEM budget pushes some layers to a
    group of 8; the port reproduces it to agree with the reference."""
    groups = {tfb.ghost_group(*shape, 4, 16, r, d, du)
              for shape, r, d, du in resnet50_bn_layers(256)}
    assert 8 in groups and 16 in groups


@pytest.mark.parametrize("shape,group,act,residual,donate,dual", CASES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_ghost_group_matches_reference_plan_test_shapes(
        shape, group, act, residual, donate, dual, itemsize):
    donate = donate and residual
    assert tfb.ghost_group(*shape, itemsize, group, residual, donate,
                           dual) == _reference_group(shape, itemsize, group,
                                                     residual, donate, dual)


def test_wrappers_check_inputs():
    x = torch.zeros(4, 8, 3, 3)
    g = torch.ones(8)
    with pytest.raises(ValueError, match="does not divide"):
        tfb.ghost_bn_fwd(x, g, g, None, 1e-5, "relu", 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfb.ghost_bn_fwd(x.double(), g, g, None, 1e-5, "relu", 2)
    with pytest.raises(ValueError, match="residual must match"):
        tfb.ghost_bn_fwd(x, g, g, torch.zeros(4, 8, 3, 2), 1e-5, "relu", 2)
    with pytest.raises(ValueError, match="act must be"):
        tfb.ghost_bn_fwd(x, g, g, None, 1e-5, "tanh", 2)
    # the card path's operand rules (device-agnostic validator)
    cpu = torch.device("cpu")
    tfb._check_cuda(cpu, {"x": x, "r": None}, {"gamma": (g, (8,)),
                                               "mean": (g[None], (1, 8))})
    for bad in ({"gamma": (g.bfloat16(), (8,))}, {"gamma": (g, (4,))},
                {"gamma": (torch.ones(16)[::2], (8,))},
                {"gamma": (g.to("meta"), (8,))}):
        with pytest.raises(ValueError, match="contiguous float32"):
            tfb._check_cuda(cpu, {}, bad)
    with pytest.raises(ValueError, match="contiguous NCHW"):
        tfb._check_cuda(cpu, {"x": x.transpose(2, 3)}, {})
