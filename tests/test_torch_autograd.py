"""The port's ``autograd`` against the JAX package's, on the CPU.

MXNet's rules, not PyTorch's: only ops inside ``record()`` are recorded;
gradients land in ``attach_grad`` buffers by ``grad_req``; ``backward``
with nothing recorded raises ``ValueError``.  Gradients are compared with
the JAX package's on the same numpy inputs: rtol 1e-5, atol 1e-6 in
float32 (sums in another order).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _arr(mx, x):
    return mx.nd.array(x, ctx=CPU) if mx is tmx else mx.nd.array(x)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _grads_both(fn, *arrays, grad_req="write"):
    """``fn(mx, *vars)`` returns a head; each side's grads of every var."""
    out = []
    for mx in (jmx, tmx):
        vs = [_arr(mx, a) for a in arrays]
        for v in vs:
            v.attach_grad(grad_req)
        with mx.autograd.record():
            head = fn(mx, *vs)
        head.backward()
        out.append([v.grad.asnumpy() for v in vs])
    for j, t in zip(*out):
        _close(t, j)
    return out[1]


@pytest.mark.parametrize("fn", [
    lambda mx, a, b: (a * b + a.exp()).sum(),
    lambda mx, a, b: mx.nd.dot(a, b.T).sigmoid().mean(),
    lambda mx, a, b: (a / (b.abs() + 1)).log_softmax(axis=1).sum(),
    lambda mx, a, b: mx.nd.batch_dot(a.reshape(2, 2, 3),
                                     b.reshape(2, 3, 2)).square().sum(),
    lambda mx, a, b: mx.nd.concat(a, b, dim=0).tanh().max(axis=1).sum(),
    lambda mx, a, b: (a.transpose() * 3).reshape((-1,)).norm(),
    lambda mx, a, b: mx.nd.stack(a, b).softmax(axis=0).slice_axis(0, 0, 1)
    .sum(),
    lambda mx, a, b: (a.slice_axis(0, 1, 2) * b.slice((0, 1), (4, 2)))
    .relu().sum(),
    lambda mx, a, b: mx.nd.broadcast_maximum(a, b).clip(-0.5, 0.5).sum(),
    lambda mx, a, b: a.take(mx.nd.array([1, 0, 1], ctx=a.context)).sum(),
])
def test_gradients_match_the_reference(fn):
    _grads_both(fn, _rand(4, 3), _rand(4, 3, seed=1))


def test_indexing_is_recorded():
    """``a[i]`` and ``a[i] = v`` inside record() are recorded, as MXNet's
    slice ops are (the JAX package's ``__getitem__`` bypasses its tape:
    ROADMAP Queue C); gradients against plain torch."""
    x, v = _rand(4, 3), _rand(3, seed=1)
    a = tmx.nd.array(x, ctx=CPU)
    b = tmx.nd.array(v, ctx=CPU)
    a.attach_grad()
    b.attach_grad()
    with tmx.autograd.record():
        c = a * 1
        c[2] = b * 2
        y = (c[1:3] * c[::-1][0]).sum()
    y.backward()
    xt = torch.tensor(x, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    ct = torch.cat([xt[:2], (vt * 2)[None], xt[3:]])
    gx, gv = torch.autograd.grad((ct[1:3] * ct.flip(0)[0]).sum(), [xt, vt])
    _close(a.grad.asnumpy(), gx.numpy())
    _close(b.grad.asnumpy(), gv.numpy())


def test_grad_req_add_accumulates_and_null_skips():
    def run(mx):
        a, b = _arr(mx, _rand(3)), _arr(mx, _rand(3, seed=1))
        a.attach_grad("add")
        b.attach_grad("null")
        for _ in range(2):
            with mx.autograd.record():
                y = (a * a * b).sum()
            y.backward()
        return a.grad.asnumpy(), b.grad.asnumpy()

    (ja, jb), (ta, tb) = run(jmx), run(tmx)
    _close(ta, ja)
    _close(tb, jb)
    assert not tb.any()
    _close(ta, 2 * 2 * _rand(3) * _rand(3, seed=1))


def test_grad_req_write_overwrites():
    a = tmx.nd.array(_rand(3), ctx=CPU)
    a.attach_grad()
    for scale in (1.0, 3.0):
        with tmx.autograd.record():
            y = (a * scale).sum()
        y.backward()
    _close(a.grad.asnumpy(), np.full(3, 3.0, np.float32))


def test_only_recorded_ops_build_a_graph():
    a = tmx.nd.array(_rand(3), ctx=CPU)
    a.attach_grad()
    y = a * 2                       # outside record(): not recorded
    assert not y._data.requires_grad
    with pytest.raises(ValueError, match="no recorded computation"):
        y.backward()
    for mx in (jmx, tmx):
        x = _arr(mx, _rand(3))
        x.attach_grad()
        with pytest.raises(ValueError, match="no recorded computation"):
            (x * 2).backward()


def test_pause_stops_recording_and_scopes_nest():
    ag = tmx.autograd
    a = tmx.nd.array(_rand(3), ctx=CPU)
    a.attach_grad()
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        b = a * 2
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            c = b * 3                      # a constant to the tape
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
        y = (b * c).sum()
    assert not ag.is_recording()
    with ag.train_mode():
        assert ag.is_training()
    with ag.record(train_mode=False):
        assert not ag.is_training()
    assert ag.set_recording(True) is False and ag.set_recording(False)
    assert ag.set_training(True) is False and ag.set_training(False)
    y.backward()
    # d/da sum(2a * 6a_const) = 12 a  (c is not differentiated)
    _close(a.grad.asnumpy(), 12 * _rand(3))


def test_retain_graph():
    a = tmx.nd.array(_rand(3), ctx=CPU)
    a.attach_grad("add")
    with tmx.autograd.record():
        y = (a * a).sum()
    y.backward(retain_graph=True)
    y.backward()
    _close(a.grad.asnumpy(), 4 * _rand(3))
    with pytest.raises(ValueError, match="no recorded computation"):
        y.backward()


def test_head_gradients_and_several_heads():
    def run(mx):
        a = _arr(mx, _rand(2, 3))
        a.attach_grad()
        with mx.autograd.record():
            y1 = a * 2
            y2 = (a * a).sum(axis=1)
        mx.autograd.backward([y1, y2], [_arr(mx, _rand(2, 3, seed=1)),
                                        _arr(mx, _rand(2, seed=2))])
        return a.grad.asnumpy()

    _close(run(tmx), run(jmx))


def test_autograd_grad_returns_without_writing():
    def run(mx):
        a, b = _arr(mx, _rand(3)), _arr(mx, _rand(3, seed=1))
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = (a * b * b).sum()
        ga, gb = mx.autograd.grad(y, [a, b])
        return ga.asnumpy(), gb.asnumpy(), a.grad.asnumpy()

    (ja, jb, jbuf), (ta, tb, tbuf) = run(jmx), run(tmx)
    _close(ta, ja)
    _close(tb, jb)
    assert not tbuf.any() and not jbuf.any()


def test_autograd_grad_single_variable_and_unused():
    a = tmx.nd.array(_rand(3), ctx=CPU)
    b = tmx.nd.array(_rand(3, seed=1), ctx=CPU)
    a.attach_grad()
    b.attach_grad()
    with tmx.autograd.record():
        y = (a * 3).sum()
    g = tmx.autograd.grad(y, a, retain_graph=True)
    _close(g.asnumpy(), np.full(3, 3.0, np.float32))
    ga, gb = tmx.autograd.grad(y, [a, b])
    assert not gb.asnumpy().any()


def test_inplace_update_of_a_variable_between_steps():
    """``w -= lr * w.grad`` swaps the tensor; w stays a variable and the
    next step's gradient lands in its buffer (the SGD idiom)."""
    def run(mx):
        w = _arr(mx, _rand(3))
        x = _arr(mx, _rand(3, seed=1))
        w.attach_grad()
        for _ in range(3):
            with mx.autograd.record():
                loss = ((w * x).sum() - 1) ** 2
            loss.backward()
            w -= 0.1 * w.grad
        return w.asnumpy(), w.grad.asnumpy()

    for t, j in zip(run(tmx), run(jmx)):
        _close(t, j)


def test_inplace_on_a_saved_array_inside_record():
    """``b += 1`` after a recorded op saved b must not trip PyTorch's
    version counter."""
    a = tmx.nd.array(_rand(3), ctx=CPU)
    a.attach_grad()
    with tmx.autograd.record():
        b = a * a
        c = b * b                # saves b
        b += 1
        y = (c + b).sum()
    y.backward()
    x = _rand(3)
    _close(a.grad.asnumpy(), 4 * x ** 3 + 2 * x)


def _square_fn(mx):
    class Square(mx.autograd.Function):
        def forward(self, x):
            self.x = x
            return x * x

        def backward(self, dy):
            return 2 * self.x * dy

    return Square


def test_function_matches_the_reference():
    def run(mx):
        a = _arr(mx, _rand(4))
        a.attach_grad()
        with mx.autograd.record():
            y = (_square_fn(mx)()(a) * 3).sum()
        y.backward()
        return a.grad.asnumpy()

    _close(run(tmx), run(jmx))


def test_function_with_two_outputs_and_save_for_backward():
    class Split(tmx.autograd.Function):
        def forward(self, x, w):
            self.save_for_backward(x, w)
            return x * w, x + w

        def backward(self, d1, d2):
            x, w = self.saved_tensors
            return d1 * w + d2, d1 * x + d2

    a = tmx.nd.array(_rand(3), ctx=CPU)
    w = tmx.nd.array(_rand(3, seed=1), ctx=CPU)
    a.attach_grad()
    w.attach_grad()
    with tmx.autograd.record():
        p, s = Split()(a, w)
        y = (p * 2 + s).sum()
    y.backward()
    _close(a.grad.asnumpy(), 2 * _rand(3, seed=1) + 1)
    _close(w.grad.asnumpy(), 2 * _rand(3) + 1)
    plain = Split()(a, w)            # outside record(): forward only
    assert not plain[0]._data.requires_grad


def test_block_grad_and_detach():
    def run(mx):
        a = _arr(mx, _rand(3))
        a.attach_grad()
        with mx.autograd.record():
            y = (a * mx.nd.BlockGrad(a) + a.detach() * a).sum()
        y.backward()
        return a.grad.asnumpy()

    _close(run(tmx), run(jmx))


def test_mark_variables_and_bad_grad_req():
    a = tmx.nd.array(_rand(3), ctx=CPU)
    g = tmx.nd.zeros((3,), ctx=CPU)
    tmx.autograd.mark_variables(a, g)
    with tmx.autograd.record():
        y = (a * 5).sum()
    y.backward()
    assert a.grad is g
    _close(g.asnumpy(), np.full(3, 5.0, np.float32))
    with pytest.raises(ValueError, match="grad_req"):
        a.attach_grad("sometimes")


def test_recording_does_not_leak_into_torch_outside_scopes():
    """A variable used by plain torch code outside record() is a leaf that
    requires grad (PyTorch's rule); the port's ops do not record it."""
    a = tmx.nd.array(_rand(3), ctx=CPU)
    a.attach_grad()
    assert a._data.requires_grad and a._data.is_leaf
    assert not (a + 1)._data.requires_grad
    assert not a.sum()._data.requires_grad
    assert not a[0]._data.requires_grad
    assert torch.is_grad_enabled()
