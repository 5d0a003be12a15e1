"""The port's int8 quantization (``incubator_mxnet_tpu_torch/ops/
quantization.py``, ``incubator_mxnet_tpu_torch/contrib/quantization.py``)
against the JAX package's, on the CPU.

- ``symmetric_quantize``/``quantize_tensor``/``dequantize_tensor``: codes
  and amax bit-equal to the reference's, all-zero, NaN, +-inf tensors
  and qmax 7 included.
- The seven registered ops on the same numpy inputs, the reference's op
  called eagerly: int32 accumulators and int8 codes exact, ranges and
  dequantized floats within 1 ulp (``ULP``).  The convolution grouped,
  strided, dilated and padded; the card's padded ``_int_mm`` path (run
  here on CPU tensors) at shapes it must pad.  The ops through ``mx.nd``
  and ``mx.sym`` as well.
- ``fold_batch_norm``: the folded graph's JSON equal to the reference's,
  the folded weights within ``FOLD_TOL`` (both fold in numpy; the
  packages' running statistics carried across).
- ``_get_optimal_threshold`` equal on the same data.
- ``quantize_graph`` on a net that hits every rewrite (conv, BN, ReLU,
  max pool, residual add, dense): JSON equal node for node.
- ``quantize_model`` under ``none``, ``naive`` and ``entropy`` and with
  ``excluded_sym_names``: the graphs equal (calibrated ranges within
  ``RANGE_TOL``: the calibration reads the port's own float outputs), the
  outputs within ``MODEL_TOL`` of the reference's.
- The reference's seven cases of ``tests/test_quantization.py``, run on
  the port with the reference's tolerances.

Inputs are numpy arrays made from seeds, in explicit float32 (or int8).
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import name as jname
from incubator_mxnet_tpu.contrib import quantization as jqz
from incubator_mxnet_tpu.ops import quantization as jq
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import name as tname
from incubator_mxnet_tpu_torch.contrib import quantization as tqz
from incubator_mxnet_tpu_torch.ops import quantization as tq
from incubator_mxnet_tpu_torch.ops import registry as treg

#: floats derived from the same codes (ranges, dequantized values)
ULP = 1
#: the folded conv weights and biases (numpy f32 on both sides; the
#: running statistics are carried across exactly)
FOLD_TOL = 0.0
#: calibrated ranges: the port's f32 activations against the reference's
RANGE_TOL = 1e-5
#: quantized model outputs, max abs error over the reference's largest
#: magnitude: a code at a rounding edge may flip where an f32 activation
#: differs by an ulp, moving an output by one quantization step
MODEL_TOL = 2e-2

CPU = tmx.cpu()


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _ref_op(name, inputs, **attrs):
    outs = jreg.OPS[name].fn(*[None if a is None else _jnp(a)
                               for a in inputs], **attrs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [np.asarray(o) for o in outs]


def _port_op(name, inputs, **attrs):
    outs = treg.OPS[name].fn(*[None if a is None else torch.from_numpy(
        np.array(a)) for a in inputs], **attrs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return [o.numpy() for o in outs]


def _same(got, want):
    """Integers exact; floats within ``ULP``; equal shapes and dtypes."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                           g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_max_ulp(g, w, maxulp=ULP)
        else:
            np.testing.assert_array_equal(g, w)


def _f32(*vals):
    return [np.float32(v) for v in vals]


# ---------------------------------------------------------------------------
# the tensor quantizers
# ---------------------------------------------------------------------------

_TENSORS = {
    "gauss": lambda: np.random.RandomState(0).randn(17, 9),
    "wide": lambda: np.random.RandomState(1).uniform(-40, 3, (5, 6, 3, 3)),
    "edges": lambda: np.array([[0.5, 1.5, -2.5, 127.0]]) / 127.0 * 3.0,
    "zeros": lambda: np.zeros((4, 4)),
    "nan": lambda: np.array([[1.0, np.nan], [2.0, -3.0]]),
    "inf": lambda: np.array([[1.0, np.inf], [2.0, -3.0]]),
    "-inf": lambda: np.array([[1.0, -np.inf], [2.0, -3.0]]),
    # the smallest normal magnitudes: XLA's CPU backend flushes f32
    # subnormals to zero, which the port does not (ROADMAP Queue C)
    "tiny": lambda: np.full((3, 3), 2.0 ** -125),
}


@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("case", sorted(_TENSORS))
def test_symmetric_quantize_bit_equal(case, qmax):
    w = _TENSORS[case]().astype(np.float32)
    jcodes, jamax = jq.symmetric_quantize(_jnp(w), qmax=qmax)
    codes, amax = tq.symmetric_quantize(torch.from_numpy(w), qmax=qmax)
    assert codes.dtype == torch.int8 and amax.dtype == torch.float32
    assert amax.shape == ()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert amax.numpy().tobytes() == np.asarray(jamax).tobytes()
    if qmax == 127.0:
        jc2, ja2 = jq.quantize_tensor(_jnp(w))
        c2, a2 = tq.quantize_tensor(torch.from_numpy(w))
        np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
        back = tq.dequantize_tensor(c2, a2).numpy()
        jback = np.asarray(jq.dequantize_tensor(jc2, ja2))
        np.testing.assert_array_equal(back, jback)


def test_symmetric_quantize_bf16_input():
    w = np.random.RandomState(2).randn(8, 8).astype(np.float32)
    import jax.numpy as jnp

    jc, ja = jq.symmetric_quantize(jnp.asarray(w).astype(jnp.bfloat16))
    c, a = tq.symmetric_quantize(torch.from_numpy(w).to(torch.bfloat16))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert float(a) == float(ja)


# ---------------------------------------------------------------------------
# the seven ops
# ---------------------------------------------------------------------------

def _rand_i8(rs, shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _op_cases():
    rs = np.random.RandomState(3)
    x = rs.uniform(-3, 5, (4, 8)).astype(np.float32)
    acc = rs.randint(-2 ** 20, 2 ** 20, (3, 5)).astype(np.int32)
    a8, b8 = _rand_i8(rs, (2, 3, 4)), _rand_i8(rs, (2, 3, 4))
    cases = {
        "quantize": ("_contrib_quantize", [x] + _f32(-2.0, 3.0), {}),
        "quantize_zero_range": ("_contrib_quantize",
                                [x] + _f32(0.0, 0.0), {}),
        "quantize_v2": ("_contrib_quantize_v2", [x], {}),
        "quantize_v2_calib": ("_contrib_quantize_v2", [x],
                              dict(min_calib_range=-1.3,
                                   max_calib_range=2.7)),
        "quantize_v2_zeros": ("_contrib_quantize_v2",
                              [np.zeros((3, 3), np.float32)], {}),
        "dequantize_int8": ("_contrib_dequantize",
                            [a8] + _f32(-1.7, 2.1), {}),
        "dequantize_int32": ("_contrib_dequantize",
                             [acc] + _f32(-3e-3, 3e-3), {}),
        "requantize": ("_contrib_requantize", [acc] + _f32(-7.5, 7.5), {}),
        "requantize_calib": ("_contrib_requantize", [acc] + _f32(-7.5, 7.5),
                             dict(min_calib_range=-2.0,
                                  max_calib_range=1.5)),
        "elemwise_add": ("_contrib_quantized_elemwise_add",
                         [a8, b8] + _f32(-1.1, 0.9, -0.3, 4.0), {}),
    }
    for m, k, n, bias in ((4, 16, 8, True), (3, 147, 5, True),
                          (17, 20, 9, False), (40, 64, 24, True)):
        d, w, b = _rand_i8(rs, (m, k)), _rand_i8(rs, (n, k)), \
            _rand_i8(rs, (n,))
        ranges = _f32(-2.0, 2.5, -0.6, 0.5) + (_f32(-1.0, 0.8) if bias
                                                 else [None, None])
        cases["fc_%dx%dx%d" % (m, k, n)] = (
            "_contrib_quantized_fully_connected",
            [d, w, b if bias else None] + ranges,
            dict(num_hidden=n, no_bias=not bias))
    d4 = _rand_i8(rs, (2, 3, 2, 4))
    w4 = _rand_i8(rs, (5, 24))
    cases["fc_flatten"] = ("_contrib_quantized_fully_connected",
                           [d4, w4, None] + _f32(-1, 1, -1, 1) + [None, None],
                           dict(num_hidden=5, no_bias=True))
    for tag, (c, o, g, k, stride, pad, dil, bias) in {
            "plain": (4, 8, 1, 3, (1, 1), (1, 1), (1, 1), True),
            "grouped": (6, 9, 3, 3, (1, 1), (0, 0), (1, 1), True),
            "strided_padded": (3, 8, 1, 7, (2, 2), (3, 3), (1, 1), True),
            "dilated": (4, 4, 2, 3, (2, 1), (1, 2), (2, 3), False),
            "depthwise": (4, 4, 4, 3, (1, 1), (1, 1), (1, 1), True)}.items():
        d = _rand_i8(rs, (2, c, 11, 10))
        w = _rand_i8(rs, (o, c // g, k, k))
        b = _rand_i8(rs, (o,))
        ranges = _f32(-1.5, 3.0, -0.2, 0.25) + (_f32(-0.5, 0.5) if bias
                                                  else [None, None])
        cases["conv_" + tag] = (
            "_contrib_quantized_conv", [d, w, b if bias else None] + ranges,
            dict(kernel=(k, k), stride=stride, pad=pad, dilate=dil,
                 num_filter=o, num_group=g, no_bias=not bias))
    return cases


_OP_CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_op_matches_reference(case):
    name, inputs, attrs = _OP_CASES[case]
    _same(_port_op(name, inputs, **attrs), _ref_op(name, inputs, **attrs))


def test_seven_ops_registered_with_reference_arity():
    names = ["_contrib_quantize", "_contrib_quantize_v2",
             "_contrib_dequantize", "_contrib_requantize",
             "_contrib_quantized_elemwise_add",
             "_contrib_quantized_fully_connected",
             "_contrib_quantized_conv"]
    for n in names:
        j, t = jreg.OPS[n], treg.OPS[n]
        assert (t.num_inputs, t.num_outputs, t.differentiable) == \
            (j.num_inputs, j.num_outputs, j.differentiable), n
    covered = {_OP_CASES[c][0] for c in _OP_CASES}
    assert covered == set(names)


@pytest.mark.parametrize("mkn", [(1, 8, 8), (3, 147, 5), (16, 16, 16),
                                 (17, 9, 3), (33, 64, 1000)])
def test_padded_int_mm_exact(mkn):
    """The card's route (zero padding to ``_int_mm``'s shapes) on CPU
    tensors: the int32 products of the reference's ``dot_general``."""
    m, k, n = mkn
    rs = np.random.RandomState(m * 1000 + k)
    a, w = _rand_i8(rs, (m, k)), _rand_i8(rs, (n, k))
    got = tq._padded_int_mm(torch.from_numpy(a), torch.from_numpy(w))
    import jax.numpy as jnp
    from jax import lax

    want = lax.dot_general(jnp.asarray(a), jnp.asarray(w),
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_on_meta_tensors_infer_shapes():
    name, inputs, attrs = _OP_CASES["conv_dilated"]
    metas = [None if a is None else torch.empty(np.shape(a), device="meta",
                                                dtype=torch.from_numpy(
                                                    np.asarray(a)).dtype)
             for a in inputs]
    outs = treg.OPS[name].infer(metas, **attrs)
    want = _ref_op(name, inputs, **attrs)
    assert [tuple(o.shape) for o in outs] == [w.shape for w in want]
    assert outs[0].dtype == torch.int32


def test_nd_and_sym_ops():
    """The ops as ``mx.nd`` and ``mx.sym`` calls, as the reference's."""
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (4, 16)).astype(np.float32)
    w = rs.uniform(-1, 1, (8, 16)).astype(np.float32)
    outs = []
    for mx in (jmx, tmx):
        kw = {} if mx is jmx else {"ctx": CPU}
        qx, xmn, xmx = mx.nd._contrib_quantize_v2(mx.nd.array(x, **kw))
        qw, wmn, wmx = mx.nd._contrib_quantize_v2(mx.nd.array(w, **kw))
        acc, omn, omx = mx.nd._contrib_quantized_fully_connected(
            qx, qw, None, xmn, xmx, wmn, wmx, num_hidden=8, no_bias=True)
        outs.append(mx.nd._contrib_dequantize(acc, omn, omx).asnumpy())
    np.testing.assert_array_max_ulp(outs[1], outs[0], maxulp=ULP)
    with tname.NameManager():
        data = tmx.sym.var("data")
        q = tmx.sym._contrib_quantize_v2(data, name="q")
        deq = tmx.sym._contrib_dequantize(q[0], q[1], q[2], name="dq")
    exe = deq.bind(CPU, {"data": tmx.nd.array(x, ctx=CPU)})
    got = exe.forward()[0].asnumpy()
    qj = jreg.OPS["_contrib_quantize_v2"].fn(_jnp(x))
    want = np.asarray(jreg.OPS["_contrib_dequantize"].fn(*qj))
    np.testing.assert_array_max_ulp(got, want, maxulp=ULP)


def test_check_out_type_refuses_uint8():
    x = np.ones((2, 2), np.float32)
    with pytest.raises(NotImplementedError, match="uint8"):
        _port_op("_contrib_quantize_v2", [x], out_type="uint8")
    with pytest.raises(NotImplementedError, match="uint8"):
        _ref_op("_contrib_quantize_v2", [x], out_type="uint8")


# ---------------------------------------------------------------------------
# int8 max pooling (the plain path, as the reference's reduce_window)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [((3, 3), (2, 2), (1, 1)),
                                 ((2, 2), (2, 2), (0, 0)),
                                 ((3, 2), (1, 2), (1, 0))])
def test_int8_max_pool_matches_reference(cfg):
    kernel, stride, pad = cfg
    x = _rand_i8(np.random.RandomState(5), (2, 3, 9, 8))
    attrs = dict(kernel=kernel, stride=stride, pad=pad, pool_type="max")
    got = _port_op("Pooling", [x], **attrs)
    want = _ref_op("Pooling", [x], **attrs)
    _same(got, want)
    assert got[0].min() >= -127  # the -128 pad never wins on codes


# ---------------------------------------------------------------------------
# graph passes
# ---------------------------------------------------------------------------

def _graph(mx):
    """A net with every rewrite: conv, BN, ReLU, max pool, a residual
    add with both operands on the int8 wire, a dense head."""
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="c1")
    bn = mx.sym.BatchNorm(c1, name="bn1", fix_gamma=False)
    r1 = mx.sym.Activation(bn, act_type="relu", name="r1")
    p1 = mx.sym.Pooling(r1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                        name="p1")
    c2 = mx.sym.Convolution(p1, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="c2")
    r2 = mx.sym.Activation(c2, act_type="relu", name="r2")
    c3 = mx.sym.Convolution(r2, num_filter=8, kernel=(1, 1), name="c3")
    add = mx.sym.elemwise_add(c3, p1, name="add")
    r3 = mx.sym.relu(add, name="r3")
    fl = mx.sym.Flatten(r3, name="fl")
    return mx.sym.FullyConnected(fl, num_hidden=5, name="fc")


def _graphs():
    with jname.NameManager():
        js = _graph(jmx)
    with tname.NameManager():
        ts = _graph(tmx)
    return js, ts


def _params(sym):
    """Arguments and aux states of ``sym`` for a (2, 3, 8, 8) batch, in
    numpy f32 from seeds; random running statistics."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, 8, 8))
    rs = np.random.RandomState(6)
    args = {n: rs.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n != "data"}
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (rs.uniform(0.5, 1.5, s) if "var" in n
                  else rs.uniform(-0.2, 0.2, s)).astype(np.float32)
    return args, aux


def _nds(mx, arrays):
    kw = {} if mx is jmx else {"ctx": CPU}
    return {k: mx.nd.array(v, **kw) for k, v in arrays.items()}


def _json(sym):
    return json.loads(sym.tojson())


def _run(mx, sym, args, aux, x):
    binds = dict(_nds(mx, args))
    kw = {} if mx is jmx else {"ctx": CPU}
    binds["data"] = mx.nd.array(x, **kw)
    exe = sym.bind(jmx.cpu() if mx is jmx else CPU, args=binds,
                   aux_states=_nds(mx, aux))
    return exe.forward(is_train=False)[0].asnumpy()


def test_quantize_graph_json_equal():
    js, ts = _graphs()
    assert _json(tqz.quantize_graph(ts)) == _json(jqz.quantize_graph(js))
    rngs = {"c1_weight": (-0.4, 0.5), "fc_weight": (-1.0, 1.0)}
    calib = {"data": (-1.0, 1.0), "p1_output": (0.0, 2.5),
             "c2_output": (-3.0, 3.0), "add_output": (-4.0, 4.5)}
    assert _json(tqz.quantize_graph(ts, ["c3"], calib, rngs)) == \
        _json(jqz.quantize_graph(js, ["c3"], calib, rngs))


def test_fold_batch_norm_matches_reference():
    js, ts = _graphs()
    args, aux = _params(ts)
    jf, jargs, jaux = jqz.fold_batch_norm(js, _nds(jmx, args),
                                          _nds(jmx, aux))
    tf, targs, taux = tqz.fold_batch_norm(ts, _nds(tmx, args),
                                          _nds(tmx, aux))
    assert _json(tf) == _json(jf)
    assert sorted(targs) == sorted(jargs) and sorted(taux) == sorted(jaux)
    for k in jargs:
        np.testing.assert_allclose(targs[k].asnumpy(), jargs[k].asnumpy(),
                                   rtol=0, atol=FOLD_TOL)
        assert targs[k].context.type == "cpu"
    x = np.random.RandomState(7).uniform(size=(2, 3, 8, 8)).astype(
        np.float32)
    np.testing.assert_allclose(_run(tmx, tf, _np(targs), {}, x),
                               _run(jmx, jf, _np(jargs), {}, x),
                               rtol=1e-5, atol=1e-5)


def _np(nds):
    return {k: v.asnumpy() for k, v in nds.items()}


def test_optimal_threshold_equal():
    rs = np.random.RandomState(8)
    for x in (np.concatenate([rs.normal(0, 1, 20000), [30.0]]),
              rs.uniform(-2, 3, 5000), np.zeros(10)):
        assert tqz._get_optimal_threshold(x) == jqz._get_optimal_threshold(x)
    hist, edges = np.histogram(np.abs(rs.normal(0, 1, 5000)), bins=601)
    assert tqz._entropy_threshold_from_hist(hist, edges) == \
        jqz._entropy_threshold_from_hist(hist, edges)


def _assert_graphs_close(got, want):
    """Equal node for node; calibration ranges within ``RANGE_TOL``."""
    assert len(got["nodes"]) == len(want["nodes"])
    for g, w in zip(got["nodes"], want["nodes"]):
        ga, wa = g.pop("attrs", {}), w.pop("attrs", {})
        assert g == w
        assert sorted(ga) == sorted(wa)
        for k in wa:
            if "calib_range" in k:
                assert abs(float(ga[k]) - float(wa[k])) <= \
                    RANGE_TOL * max(1.0, abs(float(wa[k]))), (k, ga[k], wa[k])
            else:
                assert ga[k] == wa[k], k


class _Batches:
    """Calibration batches for both packages (``batch.data[0]``)."""

    def __init__(self, mx, x, bs):
        kw = {} if mx is jmx else {"ctx": CPU}
        self.batches = [type("B", (), {"data": [mx.nd.array(x[i:i + bs],
                                                            **kw)]})()
                        for i in range(0, len(x), bs)]
        self.batch_size = bs

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("mode", ["none", "naive", "entropy", "excluded"])
def test_quantize_model_matches_reference(mode):
    js, ts = _graphs()
    args, aux = _params(ts)
    jf, jargs, jaux = jqz.fold_batch_norm(js, _nds(jmx, args),
                                          _nds(jmx, aux))
    tf, targs, taux = tqz.fold_batch_norm(ts, _nds(tmx, args),
                                          _nds(tmx, aux))
    rs = np.random.RandomState(9)
    calib = rs.uniform(-1, 1, (16, 3, 8, 8)).astype(np.float32)
    x = rs.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)
    kw = {}
    if mode in ("naive", "entropy"):
        kw = dict(calib_mode=mode, num_calib_examples=16)
    if mode == "excluded":
        kw = dict(excluded_sym_names=["c3", "fc"])
    jsym, jqa, jqx = jqz.quantize_model(
        jf, jargs, jaux, calib_data=_Batches(jmx, calib, 8), ctx=jmx.cpu(),
        **kw)
    tsym, tqa, tqx = tqz.quantize_model(
        tf, targs, taux, calib_data=_Batches(tmx, calib, 8), ctx=CPU, **kw)
    _assert_graphs_close(_json(tsym), _json(jsym))
    got = _run(tmx, tsym, _np(tqa), _np(tqx), x)
    want = _run(jmx, jsym, _np(jqa), _np(jqx), x)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= MODEL_TOL, err
    if mode == "excluded":
        assert "c3_quantized" not in tsym.tojson()
        assert "_contrib_quantized_fully_connected" not in tsym.tojson()


# ---------------------------------------------------------------------------
# the reference's seven cases (tests/test_quantization.py), on the port
# ---------------------------------------------------------------------------

nd = tmx.nd


def test_quantize_dequantize_roundtrip():
    rng = np.random.RandomState(0)
    x = nd.array(rng.uniform(-3, 5, (4, 8)).astype(np.float32), ctx=CPU)
    q, mn, mx_ = nd._contrib_quantize_v2(x)
    assert str(q.dtype) == "int8"
    back = nd._contrib_dequantize(q, mn, mx_)
    amax = max(abs(x.asnumpy().min()), abs(x.asnumpy().max()))
    np.testing.assert_allclose(back.asnumpy(), x.asnumpy(),
                               atol=amax / 127 + 1e-6)


def test_quantize_with_calib_range():
    x = nd.array(np.array([[-10.0, 0.5, 1.0, 10.0]], np.float32), ctx=CPU)
    q, mn, mx_ = nd._contrib_quantize_v2(x, min_calib_range=-2.0,
                                         max_calib_range=2.0)
    qv = q.asnumpy()
    assert qv[0, 0] == -127 and qv[0, 3] == 127
    np.testing.assert_allclose(mn.asnumpy(), -2.0)


def test_quantized_fully_connected_matches_float():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (4, 16)).astype(np.float32)
    w = rng.uniform(-1, 1, (8, 16)).astype(np.float32)
    b = rng.uniform(-1, 1, (8,)).astype(np.float32)
    qx, xmn, xmx = nd._contrib_quantize_v2(nd.array(x, ctx=CPU))
    qw, wmn, wmx = nd._contrib_quantize_v2(nd.array(w, ctx=CPU))
    qb, bmn, bmx = nd._contrib_quantize_v2(nd.array(b, ctx=CPU))
    acc, omn, omx = nd._contrib_quantized_fully_connected(
        qx, qw, qb, xmn, xmx, wmn, wmx, bmn, bmx, num_hidden=8)
    out = nd._contrib_dequantize(acc, omn, omx).asnumpy()
    np.testing.assert_allclose(out, x @ w.T + b, atol=0.15, rtol=0.1)


def test_entropy_threshold_reasonable():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.normal(0, 1, 100000), [50.0]])
    thr = tqz._get_optimal_threshold(x)
    assert 2.0 < thr < 25.0


def test_quantize_model_naive_end_to_end():
    rng = np.random.RandomState(2)
    data = tmx.sym.Variable("data")
    fc1 = tmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = tmx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = tmx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    arg = {"fc1_weight": nd.array(rng.uniform(-1, 1, (16, 8)), ctx=CPU,
                                  dtype="float32"),
           "fc1_bias": nd.zeros((16,), ctx=CPU),
           "fc2_weight": nd.array(rng.uniform(-1, 1, (4, 16)), ctx=CPU,
                                  dtype="float32"),
           "fc2_bias": nd.zeros((4,), ctx=CPU)}
    x = rng.uniform(-1, 1, (32, 8)).astype(np.float32)
    calib = tmx.io.NDArrayIter(data={"data": x}, batch_size=8, ctx=CPU)
    qsym, qarg, qaux = tqz.quantize_model(
        fc2, arg, {}, data_names=("data",), ctx=CPU, calib_mode="naive",
        calib_data=calib)
    assert "_contrib_quantized_fully_connected" in qsym.tojson()
    exe_f = fc2.bind(CPU, {"data": nd.array(x, ctx=CPU), **arg})
    ref = exe_f.forward()[0].asnumpy()
    exe_q = qsym.bind(CPU, {"data": nd.array(x, ctx=CPU), **qarg})
    out = exe_q.forward()[0].asnumpy()
    denom = max(1e-3, np.abs(ref).max())
    assert np.abs(out - ref).max() / denom < 0.1


def test_quantize_model_excluded_layers():
    data = tmx.sym.Variable("data")
    fc1 = tmx.sym.FullyConnected(data, num_hidden=4, name="fc1")
    qsym, _, _ = tqz.quantize_model(fc1, {}, {}, excluded_sym_names=["fc1"],
                                    calib_mode="none")
    assert "_contrib_quantized_fully_connected" not in qsym.tojson()


def test_fold_batch_norm_exact():
    """fold_batch_norm, then quantize_model, on an exported resnet18_v1
    after three training steps (the reference's case, its tolerances)."""
    from incubator_mxnet_tpu_torch import context, gluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    tmx.random.seed(0)
    with context.device_scope("cpu"):
        net = vision.resnet18_v1(classes=10)
    net.initialize(init=tmx.init.Xavier())
    net.shape_init((1, 3, 32, 32))
    step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer="sgd", learning_rate=0.01, momentum=0.9,
                           device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        size=(8, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(0).randint(0, 10, 8)
                         .astype(np.float32))
    for _ in range(3):
        step(x, y)
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "m")
        net.export(prefix)
        sym, args, aux = tmx.model.load_checkpoint(prefix, 0, ctx=CPU)

    def run(s, a, au, x_):
        binds = dict(a)
        binds["data"] = nd.array(x_, ctx=CPU)
        exe = s.bind(CPU, args=binds, aux_states=au)
        return exe.forward(is_train=False)[0].asnumpy()

    xnp = np.random.RandomState(1).uniform(size=(4, 3, 32, 32)) \
        .astype(np.float32)
    o_ref = run(sym, args, aux, xnp)
    fsym, fargs, faux = tqz.fold_batch_norm(sym, args, aux)
    assert fsym.tojson().count("BatchNorm") == 0
    assert not faux
    o_f = run(fsym, fargs, faux, xnp)
    np.testing.assert_allclose(o_ref, o_f, rtol=1e-3, atol=1e-3)

    qsym, qargs, qaux = tqz.quantize_model(fsym, fargs, faux,
                                           calib_mode="none")
    j = qsym.tojson()
    assert j.count("_contrib_requantize") > 0
    assert j.count("_contrib_quantized_elemwise_add") > 0
    assert j.count("_contrib_dequantize") <= 3
    o_q = run(qsym, qargs, qaux, xnp)
    cos = float((o_ref * o_q).sum()
                / (np.linalg.norm(o_ref) * np.linalg.norm(o_q) + 1e-12))
    assert cos > 0.98, cos
