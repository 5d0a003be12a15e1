"""The port's train step against the JAX package's ``make_train_step``.

The bench configuration at test size: the small ghost-BN ResNet v1 of
``test_torch_resnet.py`` with the same weights, sgd with momentum 0.9,
lr 0.01 and wd 1e-4 in MXNet's update form, ``multi_precision`` master
weights and a dynamic loss scale (hence ``nonfinite="skip"``), f32
compute.  Three steps on the same numpy batches must give the same
per-step losses, final parameters, running stats and loss scale.  The
JAX step is built with ``lint="off"``.

The bench's lr 0.1 is too coarse for a comparison at this size: after
one update the f32 rounding differences (1e-5) flip near-ties of the
max pool and of the ReLU masks, each flip reroutes a whole gradient
entry, and by step 3 the parameters differ by 1e-2 on both sides of a
correct port.  At lr 0.01 no flip happens and the sides stay within
1e-5.

Tolerance (f32): 1e-4 absolute for the losses and for the parameters
and running stats after 3 steps.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.parallel import make_train_step as jmake

from incubator_mxnet_tpu_torch import convert
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.ops import optimizer_ops
from incubator_mxnet_tpu_torch.parallel import train_step as tstep

from test_torch_resnet import IMAGE, build_pair

OPT = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9, wd=1e-4,
           multi_precision=True, loss_scale="dynamic")


def _batches(n=3):
    rng = np.random.RandomState(7)
    return [(rng.normal(size=(4, 3, IMAGE, IMAGE)).astype(np.float32),
             rng.randint(0, 10, size=4).astype(np.float32))
            for _ in range(n)]


def test_three_steps_match_reference():
    jnet, tnet = build_pair(seed=3)
    jstep = jmake(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), lint="off",
                  **OPT)
    tstep_ = tstep.make_train_step(tnet, tloss.SoftmaxCrossEntropyLoss(),
                                   device="cpu", **OPT)
    for x, y in _batches():
        jl = float(jstep(nd.array(x, dtype="float32"),
                         nd.array(y, dtype="float32")).asnumpy())
        tl = tstep_(torch.from_numpy(x), torch.from_numpy(y))
        assert tl.dtype == torch.float32 and tl.dim() == 0
        np.testing.assert_allclose(tl.item(), jl, rtol=0, atol=1e-4)
    params = list(jnet.collect_params().values())
    for p, (name, t) in zip(params, convert.ordered_tensors(tnet)):
        np.testing.assert_allclose(t.detach().numpy(), p.data().asnumpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert tstep_.loss_scale == jstep.loss_scale == 2.0 ** 16
    assert tstep_.step_count == 3 and tstep_.skipped_steps == 0


def test_nonfinite_step_is_skipped_and_scale_halves():
    """A non-finite gradient leaves params, running stats and optimizer
    state bit-identical, counts a skip and halves the dynamic scale."""
    _, tnet = build_pair(seed=4)
    step = tstep.make_train_step(tnet, tloss.SoftmaxCrossEntropyLoss(),
                                 device="cpu", **OPT)
    x, y = _batches(1)[0]
    step(torch.from_numpy(x), torch.from_numpy(y))
    before = [t.detach().clone() for _, t in convert.ordered_tensors(tnet)]
    state = [tuple(s.clone() for s in st) for st in step._opt_state]
    x[0, 0, 0, 0] = np.inf
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    assert not torch.isfinite(loss)
    for b, (name, t) in zip(before, convert.ordered_tensors(tnet)):
        assert torch.equal(b, t), name
    for s0, s1 in zip(state, step._opt_state):
        assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert step.skipped_steps == 1 and step.step_count == 1
    assert step.loss_scale == 2.0 ** 15


def test_dynamic_scale_grows_after_window():
    _, tnet = build_pair(seed=5)
    step = tstep.make_train_step(
        tnet, tloss.SoftmaxCrossEntropyLoss(), device="cpu",
        optimizer="sgd", learning_rate=0.01, momentum=0.9,
        multi_precision=True,
        loss_scale=tstep.DynamicLossScale(init_scale=4.0, scale_window=2))
    for x, y in _batches(2):
        step(torch.from_numpy(x), torch.from_numpy(y))
    assert step.loss_scale == 8.0 and step.step_count == 2


@pytest.mark.parametrize("multi_precision", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_updates_match_reference_ops(multi_precision, momentum):
    """FunctionalOptimizer against the reference's sgd update ops
    (ops/optimizer_ops.py), f32, tolerance 1e-6 absolute."""
    from incubator_mxnet_tpu.ops import optimizer_ops as jops

    rng = np.random.RandomState(0)
    w, g, m = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    kw = dict(lr=0.1, wd=1e-4, rescale_grad=0.5, clip_gradient=0.3)
    if momentum:
        jw, jm = jops._sgd_mom_update(w, g, m, momentum=momentum, **kw)
        tw, tm = optimizer_ops.sgd_mom_update(
            torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(m),
            momentum=momentum, **kw)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    else:
        jw = jops._sgd_update(w, g, **kw)
        tw = optimizer_ops.sgd_update(torch.from_numpy(w),
                                      torch.from_numpy(g), **kw)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    if multi_precision:
        w32 = w.copy()
        if momentum:
            jw, jm, jw32 = jops._mp_sgd_mom_update(w, g, m, w32,
                                                   momentum=momentum, **kw)
            tw, tm, tw32 = optimizer_ops.mp_sgd_mom_update(
                torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(m),
                torch.from_numpy(w32), momentum=momentum, **kw)
        else:
            jw, jw32 = jops._mp_sgd_update(w, g, w32, **kw)
            tw, tw32 = optimizer_ops.mp_sgd_update(
                torch.from_numpy(w), torch.from_numpy(g),
                torch.from_numpy(w32), **kw)
        np.testing.assert_allclose(tw32.numpy(), np.asarray(jw32), atol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


def test_tree_all_finite():
    ok = [torch.ones(3), torch.zeros(2, 2), torch.arange(4)]
    assert bool(optimizer_ops.tree_all_finite(ok))
    assert not bool(optimizer_ops.tree_all_finite(
        ok + [torch.tensor([1.0, float("nan")])]))
    assert not bool(optimizer_ops.tree_all_finite(
        [torch.tensor([float("-inf")])]))
