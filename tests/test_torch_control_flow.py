"""Symbolic control flow (``mx.sym.contrib.foreach``, ``while_loop``,
``cond``; ``ops/control_flow.py``) against the JAX package's, on the CPU.

The symbolic cases of the reference's ``tests/test_control_flow.py``:
each graph is composed in both packages (under a fresh ``NameManager``
each), its JSON must be the same byte for byte, and the port's
``Executor`` must give the reference's outputs (and, where the reference
test takes them, gradients) on the same numpy inputs; a ``foreach``
saved by either package runs in the other.  ``while_loop`` runs its
``max_iterations`` masked steps as the reference's bounded scan does
(rows after the loop ends are zero).  Tolerances (f32): 1e-6 absolute
(a few adds and multiplies a step, in the same order).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = dict(rtol=0, atol=1e-6)


def _both(build):
    with jmx.name.NameManager():
        js = build(jmx.sym)
    with tmx.name.NameManager():
        ts = build(tmx.sym)
    return js, ts


def _run(mod, sym, inputs, is_train=False, head=None, grads=()):
    ctx = CPU if mod is tmx else jmx.cpu()

    def arr(v):
        return mod.nd.array(v, ctx=CPU) if mod is tmx else mod.nd.array(v)

    args = {k: arr(v) for k, v in inputs.items()}
    args_grad = {k: arr(np.zeros_like(inputs[k])) for k in grads} or None
    exe = sym.bind(ctx, args, args_grad=args_grad)
    outs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    if head is not None:
        exe.backward([arr(h) for h in head])
    return outs, {k: exe.grad_dict[k].asnumpy() for k in grads}


def _rnn_like(S):
    data, init, w = S.Variable("data"), S.Variable("init"), S.Variable("w")

    def body(x, s):
        new = S.broadcast_add(x * w, s)
        return new, new

    outs, final = S.contrib.foreach(body, data, init)
    return S.Group([outs, final])


T, N, H = 4, 2, 3


def _rnn_inputs():
    rng = np.random.RandomState(0)
    return {"data": rng.uniform(size=(T, N, H)).astype(np.float32),
            "init": np.zeros((N, H), np.float32),
            "w": rng.uniform(size=(H,)).astype(np.float32)}


def test_sym_foreach_rnn_like():
    js, ts = _both(_rnn_like)
    assert ts.tojson() == js.tojson()
    assert sorted(ts.list_arguments()) == ["data", "init", "w"]
    inputs = _rnn_inputs()
    rng = np.random.RandomState(1)
    head = [rng.normal(size=(T, N, H)).astype(np.float32),
            rng.normal(size=(N, H)).astype(np.float32)]
    kw = dict(is_train=True, head=head, grads=("data", "init", "w"))
    tout, tgrad = _run(tmx, ts, inputs, **kw)
    jout, jgrad = _run(jmx, js, inputs, **kw)
    s, expect = inputs["init"], []
    for t in range(T):
        s = inputs["data"][t] * inputs["w"] + s
        expect.append(s)
    np.testing.assert_allclose(tout[0], np.stack(expect), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, **TOL)
    for k in tgrad:
        np.testing.assert_allclose(tgrad[k], jgrad[k], **TOL, err_msg=k)


def test_sym_foreach_shapes_and_simple_bind():
    _, ts = _both(_rnn_like)
    shapes = dict(data=(T, N, H), init=(N, H), w=(H,))
    arg_shapes, out_shapes, _ = ts.infer_shape(**shapes)
    assert out_shapes == [(T, N, H), (N, H)]
    exe = ts.simple_bind(CPU, **shapes)
    inputs = _rnn_inputs()
    outs = exe.forward(**{k: tmx.nd.array(v, ctx=CPU)
                          for k, v in inputs.items()})
    assert [o.shape for o in outs] == out_shapes


def _foreach_sum(S):
    data, init = S.Variable("data"), S.Variable("init")
    outs, final = S.contrib.foreach(lambda x, s: (x + s, x + s), data, init)
    return final


def test_sym_foreach_backward():
    js, ts = _both(_foreach_sum)
    inputs = {"data": np.ones((3, 2), np.float32),
              "init": np.zeros((2,), np.float32)}
    kw = dict(is_train=True, head=[np.ones((2,), np.float32)],
              grads=("data", "init"))
    _, tgrad = _run(tmx, ts, inputs, **kw)
    _, jgrad = _run(jmx, js, inputs, **kw)
    np.testing.assert_allclose(tgrad["data"], np.ones((3, 2)), **TOL)
    np.testing.assert_allclose(tgrad["init"], np.ones((2,)), **TOL)
    for k in tgrad:
        np.testing.assert_allclose(tgrad[k], jgrad[k], **TOL)


def _while(S):
    i, s = S.Variable("i"), S.Variable("s")
    outs, final = S.contrib.while_loop(
        lambda i, s: i < 5, lambda i, s: (s + i, [i + 1, s + i]), [i, s],
        max_iterations=8)
    return S.Group([outs] + final)


def test_sym_while_loop():
    js, ts = _both(_while)
    assert ts.tojson() == js.tojson()
    inputs = {"i": np.zeros(1, np.float32), "s": np.zeros(1, np.float32)}
    tout, _ = _run(tmx, ts, inputs)
    jout, _ = _run(jmx, js, inputs)
    assert tout[0].shape == (8, 1)
    np.testing.assert_allclose(tout[1], [5.0], **TOL)
    np.testing.assert_allclose(tout[2], [10.0], **TOL)
    np.testing.assert_allclose(tout[0][5:], 0, **TOL)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, **TOL)


def _while_doubling(S):
    x = S.Variable("x")
    _, final = S.contrib.while_loop(lambda v: S.sum(v) < 100,
                                    lambda v: (v * 2, [v * 2]), [x],
                                    max_iterations=3)
    return final[0]


@pytest.mark.parametrize("x0", [1.0, 30.0])
def test_sym_while_loop_backward(x0):
    """Three doublings (d/dx 8), or two before the bound stops it (d/dx
    4): the masked steps carry no gradient."""
    js, ts = _both(_while_doubling)
    inputs = {"x": np.array([x0], np.float32)}
    kw = dict(is_train=True, head=[np.ones(1, np.float32)], grads=("x",))
    tout, tgrad = _run(tmx, ts, inputs, **kw)
    jout, jgrad = _run(jmx, js, inputs, **kw)
    np.testing.assert_allclose(tgrad["x"], [8.0 if x0 == 1.0 else 4.0],
                               **TOL)
    np.testing.assert_allclose(tout[0], jout[0], **TOL)
    np.testing.assert_allclose(tgrad["x"], jgrad["x"], **TOL)


def _cond(S):
    x = S.Variable("x")
    return S.contrib.cond(lambda: S.sum(x) > 1, lambda: x * 10,
                          lambda: x - 1)


@pytest.mark.parametrize("x0,want", [(2.0, 20.0), (0.5, -0.5)])
def test_sym_cond(x0, want):
    js, ts = _both(_cond)
    assert ts.tojson() == js.tojson()
    inputs = {"x": np.array([x0], np.float32)}
    kw = dict(is_train=True, head=[np.ones(1, np.float32)], grads=("x",))
    tout, tgrad = _run(tmx, ts, inputs, **kw)
    jout, jgrad = _run(jmx, js, inputs, **kw)
    np.testing.assert_allclose(tout[0], [want], **TOL)
    np.testing.assert_allclose(tout[0], jout[0], **TOL)
    np.testing.assert_allclose(tgrad["x"], jgrad["x"], **TOL)


def _roundtrip_inputs():
    return {"data": np.ones((3, 2), np.float32),
            "init": np.zeros((2,), np.float32)}


def test_foreach_json_roundtrip():
    _, ts = _both(_foreach_sum)
    again = tmx.sym.load_json(ts.tojson())
    assert again.tojson() == ts.tojson()
    out, _ = _run(tmx, again, _roundtrip_inputs())
    np.testing.assert_allclose(out[0], np.full((2,), 3.0), **TOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_foreach_json_crosses_packages(writer, tmp_path):
    """A ``foreach`` saved by one package (its body nested in the node's
    ``__subgraph_json__:`` attribute) loads and runs in the other."""
    js, ts = _both(_rnn_like)
    path = str(tmp_path / "foreach-symbol.json")
    (js if writer == "reference" else ts).save(path)
    reader = tmx if writer == "reference" else jmx
    loaded = reader.sym.load(path)
    assert loaded.list_arguments() == ts.list_arguments()
    inputs = _rnn_inputs()
    got, _ = _run(reader, loaded, inputs)
    want, _ = _run(jmx if writer == "reference" else tmx,
                   js if writer == "reference" else ts, inputs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
