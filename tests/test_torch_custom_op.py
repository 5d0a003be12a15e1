"""``mx.operator`` and the ``Custom`` op: the port against the JAX package
on the CPU.

The same ``CustomOp``/``CustomOpProp`` bodies are registered in both
packages (``_ops(pkg)``) and called on the same numpy inputs: eagerly,
recorded with ``autograd`` and through ``mx.sym`` into an ``Executor``,
with one and two outputs, as the reference's ``tests/test_custom_op.py``
does.  Forward values and input gradients within 1e-6 (relative to the
largest magnitude, at least 1e-6 absolute).  Callbacks see the port's
NDArrays on the inputs' device, which also answer the reference's host
view (``np.asarray``, indexing, slice assignment from numpy).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx

TOL = 1e-6


def _ops(pkg, tag):
    """Register the test ops in ``pkg`` under names ending in ``tag``;
    returns {kind: op_type}.  The bodies use only what both packages'
    callback arrays offer."""
    op_mod = pkg.operator
    seen = {"forward": 0, "backward": 0, "device": []}

    class Sqr(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen["forward"] += 1
            seen["device"].append(getattr(in_data[0], "context", None))
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            seen["backward"] += 1
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    class SqrProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class TwoOut(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] + 1)
            self.assign(out_data[1], req[1], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] + 2 * out_grad[1])

    class TwoOutProp(op_mod.CustomOpProp):
        def list_outputs(self):
            return ["plus", "times"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOut()

    class HostView(op_mod.CustomOp):
        """The reference's host-array surface: np.asarray, asnumpy,
        shape, dtype, indexing and slice assignment from numpy, and an
        ``add`` request."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = np.asarray(in_data[0])
            assert in_data[0].shape == x.shape
            assert np.dtype(in_data[0].dtype) == np.float32
            y = np.tanh(x) * float(self.scale)
            out_data[0][:] = y
            out_data[0][0] = in_data[0].asnumpy()[0] * 3
            self.assign(out_data[1], "write", in_data[1] * in_data[0])
            self.assign(out_data[1], "add", in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = np.asarray(in_data[0])
            g0 = np.asarray(out_grad[0]) * float(self.scale) * (
                1 - np.tanh(x) ** 2)
            g0[0] = np.asarray(out_grad[0])[0] * 3
            in_grad[0][:] = g0 + np.asarray(out_grad[1]) * np.asarray(
                in_data[1])
            self.assign(in_grad[1], req[1], out_grad[1] * in_data[0]
                        + out_grad[1])

    class HostViewProp(op_mod.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__()
            self.scale = float(scale)

        def list_arguments(self):
            return ["data", "other"]

        def list_outputs(self):
            return ["tanh", "prod"]

        def create_operator(self, ctx, shapes, dtypes):
            op = HostView()
            op.scale = self.scale
            return op

    class Softmax(op_mod.CustomOp):
        """The reference docs' custom softmax head: softmax forward,
        (p - onehot(label)) / batch backward; in nd ops on the port, in
        numpy on the reference (its callbacks get host arrays)."""

        def forward(self, is_train, req, in_data, out_data, aux):
            if pkg is not mx:
                x = np.asarray(in_data[0])
                e = np.exp(x - x.max(axis=1, keepdims=True))
                self.assign(out_data[0], req[0], e / e.sum(1, keepdims=True))
                return
            self.assign(out_data[0], req[0],
                        pkg.nd.softmax(in_data[0], axis=-1))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            if pkg is not mx:
                p = np.array(out_data[0])
                p[np.arange(p.shape[0]),
                  np.asarray(in_data[1]).astype(int)] -= 1.0
                self.assign(in_grad[0], req[0], p / p.shape[0])
                return
            p = out_data[0]
            onehot = pkg.nd.one_hot(in_data[1], p.shape[1])
            self.assign(in_grad[0], req[0], (p - onehot) / p.shape[0])

    class SoftmaxProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    names = {}
    for kind, prop in (("sqr", SqrProp), ("twoout", TwoOutProp),
                       ("host", HostViewProp), ("softmax", SoftmaxProp)):
        names[kind] = "%s_%s" % (kind, tag)
        op_mod.register(names[kind])(prop)
    names["seen"] = seen
    return names


J = _ops(jmx, "torch_test")
T = _ops(mx, "torch_test")
_RNG = np.random.RandomState(5)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    limit = TOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.astype(np.float64) - want).max()) <= limit, what


def _eager(pkg, names, kind, arrays, attrs, ctx, record):
    """Outputs and input gradients of ``Custom`` on ``arrays`` (gradients
    of the sum of each output times a fixed cotangent)."""
    nd = pkg.nd
    xs = [nd.array(a, ctx=ctx) for a in arrays]
    if not record:
        out = nd.Custom(*xs, op_type=names[kind], **attrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in outs], None
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = nd.Custom(*xs, op_type=names[kind], **attrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        rng = np.random.RandomState(9)
        loss = None
        for o in outs:
            c = nd.array(rng.uniform(-1, 1, o.shape).astype(np.float32),
                         ctx=ctx)
            term = (o * c).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


CASES = {
    "sqr": ("sqr", [_RNG.normal(size=(2, 3)).astype(np.float32)], {}),
    "twoout": ("twoout", [_RNG.normal(size=(4,)).astype(np.float32)], {}),
    "host": ("host", [_RNG.normal(size=(3, 4)).astype(np.float32),
                      _RNG.normal(size=(3, 4)).astype(np.float32)],
             dict(scale=0.5)),
}


@pytest.mark.parametrize("record", [False, True], ids=["eager", "recorded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_custom_matches_reference(case, record):
    kind, arrays, attrs = CASES[case]
    want, want_g = _eager(jmx, J, kind, arrays, attrs, jmx.cpu(), record)
    got, got_g = _eager(mx, T, kind, arrays, attrs, mx.cpu(), record)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "%s output %d" % (case, i))
    for i, (g, w) in enumerate(zip(got_g or [], want_g or [])):
        _close(g, w, "%s gradient %d" % (case, i))


def test_custom_softmax_head_gradient():
    """The docs' softmax head: its forward equals ``softmax`` and its
    input gradient is ``(p - onehot) / batch``, in both packages alike;
    no cotangent reaches it (``need_top_grad`` False), as the loss head
    of a net."""
    x = _RNG.normal(size=(6, 5)).astype(np.float32)
    y = _RNG.randint(0, 5, 6).astype(np.float32)
    res = {}
    for pkg, names in ((jmx, J), (mx, T)):
        data = pkg.nd.array(x, ctx=pkg.cpu())
        label = pkg.nd.array(y, ctx=pkg.cpu())
        data.attach_grad()
        with pkg.autograd.record():
            p = pkg.nd.Custom(data, label, op_type=names["softmax"])
        p.backward()
        res[pkg.__name__] = (p.asnumpy(), data.grad.asnumpy())
    (pj, gj), (pt, gt) = res.values()
    e = np.exp(x - x.max(1, keepdims=True))
    want = e / e.sum(1, keepdims=True)
    _close(pt, pj, "softmax")
    _close(pt, want, "softmax vs numpy")
    onehot = np.eye(5, dtype=np.float32)[y.astype(int)]
    _close(gt, gj, "head gradient")
    _close(gt, (want - onehot) / 6, "head gradient vs numpy")


def test_callbacks_see_ndarrays_on_the_inputs_device():
    """Forward creates one operator and backward another; the callback's
    arrays are the port's NDArrays on the inputs' device."""
    seen = T["seen"]
    seen.update(forward=0, backward=0, device=[])
    x = mx.nd.array(np.ones((2, 2), np.float32), ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type=T["sqr"])
    y.backward()
    assert seen["forward"] == 1 and seen["backward"] == 1
    assert seen["device"] == [torch.device("cpu")]


def test_custom_symbolic_two_outputs_through_executor():
    """``mx.sym.Custom`` composes with the prop's output count (two here)
    and binds into an ``Executor``; forward and backward equal the
    reference's.  Shape inference answers from ``infer_shape`` without
    running a callback."""
    x = _RNG.normal(size=(3,)).astype(np.float32)
    heads = [np.ones(3, np.float32), np.full(3, 0.5, np.float32)]
    res = {}
    for pkg, names in ((jmx, J), (mx, T)):
        ctx = pkg.cpu()
        sym = pkg.sym.Custom(pkg.sym.Variable("data"),
                             op_type=names["twoout"], name="two")
        assert sym.list_outputs() == ["two_output0", "two_output1"]
        exe = sym.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                       args_grad={"data": pkg.nd.zeros((3,), ctx=ctx)})
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward([pkg.nd.array(h, ctx=ctx) for h in heads])
        res[pkg.__name__] = outs + [exe.grad_dict["data"].asnumpy()]
    for g, w in zip(*res.values()):
        _close(g, w, "symbolic")
    seen = T["seen"]
    seen.update(forward=0)
    sym = mx.sym.Custom(mx.sym.Variable("data"), op_type=T["sqr"])
    assert sym.infer_shape(data=(5, 7))[1] == [(5, 7)]
    assert sym.infer_type(data=np.float32)[1] == [np.float32]
    assert seen["forward"] == 0


def test_operator_module_surface():
    """The module's names: the registered props, ``NDArrayOp`` raising, and
    the registry's reflection as the reference's (the op list equal, an
    op's inputs and arguments equal)."""
    assert {T[k] for k in ("sqr", "twoout", "host", "softmax")} <= set(
        mx.operator.get_all_registered())
    with pytest.raises(NotImplementedError):
        mx.operator.NDArrayOp()
    assert mx.operator.get_all_op_names() == jmx.operator.get_all_op_names()
    for name in ("moments", "_contrib_Proposal", "multi_lars", "Custom",
                 "_contrib_interleaved_matmul_selfatt_qk", "im2col"):
        got, want = mx.operator.get_op_info(name), \
            jmx.operator.get_op_info(name)
        assert got["inputs"] == want["inputs"], name
        assert got["arguments"] == want["arguments"], name
        assert got["num_outputs"] == want["num_outputs"], name
        assert mx.operator.get_op_doc(name).splitlines()[0] == name
    with pytest.raises(ValueError, match="not registered"):
        mx.nd.Custom(mx.nd.ones((2,), ctx=mx.cpu()), op_type="no_such_op")
