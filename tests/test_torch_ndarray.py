"""The port's ``nd`` against the JAX package's, op by op, on the CPU.

The same seeded numpy inputs go through ``incubator_mxnet_tpu.nd`` and
``incubator_mxnet_tpu_torch.nd`` (``ctx=cpu()``); values, shapes and
dtypes must agree.  Tolerance: rtol 1e-5, atol 1e-6 in float32 (XLA's
and PyTorch's elementwise functions differ by a few ulps; sums run in
another order); integer, boolean and index results exactly.
"""
import numpy as np
import pytest
import torch
import torch.utils.dlpack

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(j, t):
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b)
        return
    jn, tn = _np(j), _np(t)
    assert tn.dtype == jn.dtype, (tn.dtype, jn.dtype)
    assert tn.shape == jn.shape, (tn.shape, jn.shape)
    if jn.dtype.kind in "fc":
        np.testing.assert_allclose(tn, jn, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(tn, jn)


def _both(fn, *arrays):
    """``fn(mx, *NDArrays)`` through both packages; results compared."""
    j = fn(jmx, *[jmx.nd.array(a) for a in arrays])
    t = fn(tmx, *[tmx.nd.array(a, ctx=CPU) for a in arrays])
    _same(j, t)
    return t


def _rand(*shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

_UNARY_DOMAIN = {
    "log": (0.1, 3), "log10": (0.1, 3), "log2": (0.1, 3), "log1p": (0, 3),
    "sqrt": (0.1, 3), "rsqrt": (0.1, 3), "gamma": (0.5, 3),
    "gammaln": (0.5, 3), "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
    "arctanh": (-0.9, 0.9), "erfinv": (-0.9, 0.9), "arccosh": (1.1, 3),
    "reciprocal": (0.5, 3), "rcbrt": (0.5, 3),
}
_UNARY = ["relu", "sigmoid", "hard_sigmoid", "softsign", "tanh", "exp",
          "expm1", "log", "log10", "log2", "log1p", "sqrt", "rsqrt", "cbrt",
          "rcbrt", "square", "reciprocal", "negative", "abs", "erf",
          "erfinv", "gamma", "gammaln", "sin", "cos", "tan", "arcsin",
          "arccos", "arctan", "sinh", "cosh", "arcsinh", "arccosh",
          "arctanh", "degrees", "radians", "identity", "logical_not",
          "sign", "round", "rint", "ceil", "floor", "trunc", "fix", "_copy"]


@pytest.mark.parametrize("name", _UNARY)
def test_unary(name):
    lo, hi = _UNARY_DOMAIN.get(name, (-2.5, 2.5))
    x = _rand(3, 5, lo=lo, hi=hi)
    if name == "logical_not":
        x[0, :2] = 0
    _both(lambda mx, a: getattr(mx.nd, name)(a), x)


_BINARY = ["broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
           "broadcast_mod", "broadcast_power", "broadcast_maximum",
           "broadcast_minimum", "broadcast_hypot", "elemwise_add", "_minus",
           "_Mul", "_div", "pow", "_maximum", "broadcast_equal",
           "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_logical_and",
           "broadcast_logical_or", "broadcast_logical_xor", "_equal"]


@pytest.mark.parametrize("name", _BINARY)
def test_binary_broadcast(name):
    a = np.round(_rand(2, 3, 4, lo=0.5, hi=3), 1)
    b = np.round(_rand(3, 1, lo=0.5, hi=3, seed=1), 1)
    a[0, 0, :2] = b[0, 0]
    _both(lambda mx, x, y: getattr(mx.nd, name)(x, y), a, b)


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "%", "**", "==", "!=",
                                ">", ">=", "<", "<=", "r+", "r-", "r*", "r/"])
def test_operators(op):
    a = np.round(_rand(3, 4, lo=0.5, hi=3), 1)
    b = np.round(_rand(3, 4, lo=0.5, hi=3, seed=1), 1)
    a[0] = b[0]

    def fn(mx, x, y):
        if op.startswith("r"):
            return eval("2.5 %s x" % op[1:])  # noqa: S307
        return [eval("x %s y" % op), eval("x %s 1.5" % op)]  # noqa: S307

    _both(fn, a, b)


def test_unary_operators_and_clip():
    x = _rand(4, 3)
    _both(lambda mx, a: [-a, abs(a), a.clip(-1, 0.5), mx.nd.clip(a, 0, 1)],
          x)


# ---------------------------------------------------------------------------
# reductions, arg-extremes, sorting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sum", "mean", "prod", "max", "min",
                                  "nansum", "nanprod", "sum_axis"])
@pytest.mark.parametrize("kw", [{}, {"axis": 1}, {"axis": (0, 2)},
                                {"axis": 1, "keepdims": True},
                                {"axis": 1, "exclude": True},
                                {"keepdims": True}])
def test_reductions(name, kw):
    x = _rand(2, 3, 4, lo=0.5, hi=1.5)
    x[1, 1, 1] = np.nan if name.startswith("nan") else x[1, 1, 1]
    _both(lambda mx, a: getattr(mx.nd, name)(a, **kw), x)


def test_reduction_methods():
    x = _rand(3, 4, lo=0.5, hi=1.5)
    _both(lambda mx, a: [a.sum(), a.mean(axis=0), a.prod(axis=1),
                         a.max(axis=1, keepdims=True), a.min(),
                         a.sum(axis=0, exclude=True)], x)


@pytest.mark.parametrize("kw", [{}, {"ord": 1}, {"axis": 1},
                                {"axis": (0, 1), "keepdims": True},
                                {"ord": 1, "axis": 2}])
def test_norm(kw):
    _both(lambda mx, a: [mx.nd.norm(a, **kw), a.norm(**kw)], _rand(2, 3, 4))


@pytest.mark.parametrize("name", ["argmax", "argmin"])
@pytest.mark.parametrize("kw", [{}, {"axis": 1}, {"axis": 0,
                                                  "keepdims": True},
                                {"keepdims": True}])
def test_arg_extremes_are_float32(name, kw):
    x = np.round(_rand(4, 5), 0)          # ties: the first index wins
    t = _both(lambda mx, a: getattr(a, name)(**kw), x)
    assert t.dtype == np.float32


def test_argmax_channel():
    _both(lambda mx, a: mx.nd.argmax_channel(a), _rand(3, 4, 2))


@pytest.mark.parametrize("kw", [{}, {"axis": 0}, {"is_ascend": False},
                                {"axis": 0, "is_ascend": False}])
def test_sort_argsort(kw):
    x = np.round(_rand(4, 6), 0)          # ties keep a stable order
    _both(lambda mx, a: [a.sort(**kw), a.argsort(**kw),
                         mx.nd.argsort(a, dtype="int32", **kw)], x)


@pytest.mark.parametrize("kw", [{"k": 2}, {"k": 3, "axis": 0},
                                {"k": 2, "is_ascend": True},
                                {"k": 2, "ret_typ": "value"},
                                {"k": 2, "ret_typ": "both"},
                                {"k": 2, "ret_typ": "mask"},
                                {"k": 1, "axis": 0, "ret_typ": "both",
                                 "is_ascend": True}])
def test_topk(kw):
    # + 0.0 turns -0.0 into 0.0: lax.top_k orders -0.0 below 0.0
    x = np.round(_rand(4, 6), 0) + np.float32(0.0)
    _both(lambda mx, a: a.topk(**kw), x)


# ---------------------------------------------------------------------------
# products and softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sa,sb,kw", [
    ((3, 4), (4, 5), {}),
    ((2, 3, 4), (4, 5), {}),
    ((4,), (4,), {}),
    ((4, 3), (4, 5), {"transpose_a": True}),
    ((3, 4), (5, 4), {"transpose_b": True}),
    ((4, 3), (5, 4), {"transpose_a": True, "transpose_b": True}),
])
def test_dot(sa, sb, kw):
    _both(lambda mx, a, b: [mx.nd.dot(a, b, **kw), a.dot(b, **kw)],
          _rand(*sa), _rand(*sb, seed=1))


def test_matmul_operator():
    _both(lambda mx, a, b: a @ b, _rand(3, 4), _rand(4, 2, seed=1))


@pytest.mark.parametrize("kw", [{}, {"transpose_a": True},
                                {"transpose_b": True}])
def test_batch_dot(kw):
    a, b = _rand(2, 3, 3), _rand(2, 3, 3, seed=1)
    _both(lambda mx, x, y: mx.nd.batch_dot(x, y, **kw), a, b)


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
@pytest.mark.parametrize("kw", [{}, {"axis": 0}, {"temperature": 2.0}])
def test_softmax(name, kw):
    _both(lambda mx, a: getattr(mx.nd, name)(a, **kw), _rand(3, 5))


def test_softmax_methods_and_activations():
    _both(lambda mx, a: [a.softmax(), a.log_softmax(axis=0), a.relu(),
                         a.sigmoid(), a.tanh(), a.exp(), a.square(),
                         a.abs().sqrt(), a.abs().log(), a.sign()],
          _rand(3, 5))


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,shape", [
    ((2, 3, 4), (4, 0, 2)),
    ((2, 3, 4), (6, 1, -1)),
    ((2, 3, 4), (3, -1)),
    ((2, 3, 4), (-2,)),
    ((2, 3, 4), (2, -2)),
    ((2, 3, 4), (-3, 4)),
    ((2, 3, 4), (2, -3)),
    ((2, 3, 4), (-4, 1, 2, -2)),
    ((2, 3, 4), (2, -4, -1, 1, 4)),
    ((2, 3, 4), (-4, 2, -1, 3, 4)),
    ((2, 3, 4, 5), (-3, -3)),
    ((2, 3, 4, 5), (0, 0, -1)),
    ((2, 3, 4, 5), (-1, 0, 0)),
])
@pytest.mark.parametrize("reverse", [False, True])
def test_reshape_codes(src, shape, reverse):
    x = _rand(*src)
    try:
        want = jmx.nd.array(x).reshape(shape, reverse=reverse)
    except (TypeError, ValueError, IndexError):
        # a code list the reference refuses in this direction: the port
        # refuses it too
        with pytest.raises((RuntimeError, ValueError, IndexError)):
            tmx.nd.array(x, ctx=CPU).reshape(shape, reverse=reverse)
        return
    got = tmx.nd.array(x, ctx=CPU).reshape(shape, reverse=reverse)
    _same(want, got)


def test_reshape_forms():
    x = _rand(2, 3, 4)
    _both(lambda mx, a: [a.reshape(6, 4), a.reshape((4, 6)),
                         a.reshape(shape=(3, 8)), mx.nd.reshape(a, (24,)),
                         mx.nd.Reshape(a, shape=(0, -1)),
                         a.reshape_like(mx.nd.zeros((4, 6), ctx=a.context)),
                         a.flatten(), mx.nd.Flatten(a)], x)


@pytest.mark.parametrize("fn", [
    lambda mx, a: a.transpose(),
    lambda mx, a: a.transpose((1, 0, 2)),
    lambda mx, a: a.T,
    lambda mx, a: mx.nd.transpose(a, axes=(2, 0, 1)),
    lambda mx, a: a.expand_dims(1),
    lambda mx, a: a.expand_dims(-1),
    lambda mx, a: a.reshape(2, 1, 3, 4).squeeze(),
    lambda mx, a: a.reshape(2, 1, 3, 4).squeeze(axis=1),
    lambda mx, a: a.swapaxes(0, 2),
    lambda mx, a: mx.nd.swapaxes(a, 0, 1),
    lambda mx, a: a.slice((0, 1), (2, 3)),
    lambda mx, a: a.slice((None, 0, 0), (None, 3, 4), (None, 2, 3)),
    lambda mx, a: a.slice((1, None, 3), (None, None, 0), (-1, 1, -2)),
    lambda mx, a: mx.nd.slice(a, begin=(0, 0, 1), end=(1, 2, 4)),
    lambda mx, a: a.slice_axis(1, 1, 3),
    lambda mx, a: a.slice_axis(2, 0, None),
    lambda mx, a: mx.nd.slice_axis(a, axis=0, begin=1, end=2),
    lambda mx, a: a[:, 0:1].broadcast_to((2, 3, 4)),
    lambda mx, a: a[:, 0:1].broadcast_to((0, 5, 0)),
    lambda mx, a: a[0:1].broadcast_like(a),
    lambda mx, a: a.tile((2, 1, 1)),
    lambda mx, a: a.tile((2,)),
    lambda mx, a: a.repeat(2),
    lambda mx, a: a.repeat(3, axis=1),
    lambda mx, a: a.flip(1),
    lambda mx, a: mx.nd.reverse(a, axis=(0, 2)),
    lambda mx, a: a.split(3, axis=1),
    lambda mx, a: a.split(2, axis=0, squeeze_axis=True),
    lambda mx, a: mx.nd.SliceChannel(a, num_outputs=2, axis=2),
    lambda mx, a: mx.nd.concat(a, a * 2, dim=1),
    lambda mx, a: mx.nd.Concat(a, a, a, dim=0),
    lambda mx, a: mx.nd.stack(a, a * 3, axis=1),
    lambda mx, a: a.zeros_like(),
    lambda mx, a: a.ones_like(),
    lambda mx, a: mx.nd.zeros_like(a),
])
def test_shape_ops(fn):
    _both(fn, _rand(2, 3, 4))


@pytest.mark.parametrize("mode,width", [
    ("constant", (0, 0, 0, 0, 1, 2, 2, 1)),
    ("edge", (0, 0, 0, 0, 1, 1, 2, 2)),
    ("reflect", (0, 0, 0, 0, 2, 1, 1, 2)),
])
def test_pad(mode, width):
    _both(lambda mx, a: a.pad(mode=mode, pad_width=width,
                              constant_value=0.5), _rand(1, 2, 3, 4))


@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_take(mode):
    idx = np.array([[0, 2], [4, -1]], np.float32)
    _both(lambda mx, a, i: mx.nd.take(a, i, mode=mode), _rand(3, 4), idx)


def test_take_method_and_one_hot():
    idx = np.array([0, 2, 1, 5, -1], np.float32)
    _both(lambda mx, a, i: [a.take(i), i.one_hot(4),
                            mx.nd.one_hot(i, depth=3, on_value=2.0,
                                          off_value=-1.0)],
          _rand(3, 4), idx)


# ---------------------------------------------------------------------------
# factories and dtypes
# ---------------------------------------------------------------------------


def test_factories_and_dtypes():
    def fn(mx, ctx):
        nd = mx.nd
        return [nd.array([1.0, 2.0], ctx=ctx), nd.array([1, 2], ctx=ctx),
                nd.array(np.ones(3, np.int32), ctx=ctx),
                nd.array([[1.5]], ctx=ctx, dtype="float16"),
                nd.zeros((2, 3), ctx=ctx), nd.ones(4, ctx=ctx, dtype="int32"),
                nd.full((2, 2), 7.0, ctx=ctx), nd.empty((1, 2), ctx=ctx),
                nd.arange(5, ctx=ctx), nd.arange(1, 7, 2, ctx=ctx),
                nd.arange(0, 3, 1, repeat=2, ctx=ctx),
                nd.arange(4, ctx=ctx, dtype="int32"),
                nd._zeros(shape=(2,), ctx=ctx), nd._full(shape=(2,), value=3,
                                                         ctx=ctx)]

    j, t = fn(jmx, None), fn(tmx, CPU)
    _same(j, t)
    assert t[0].dtype == np.float32 and t[8].dtype == np.float32


def test_ndarray_meta_and_transfers():
    x = _rand(2, 3)
    j, t = jmx.nd.array(x), tmx.nd.array(x, ctx=CPU)
    assert (t.shape, t.size, t.ndim, len(t), t.stype) == \
        (j.shape, j.size, j.ndim, len(j), j.stype)
    assert t.context == CPU and t.ctx == CPU
    _same(j.astype("int32"), t.astype("int32"))
    _same(j.copy(), t.copy())
    assert t.astype("float32", copy=False) is t
    s = tmx.nd.array([3.5], ctx=CPU)
    assert s.asscalar() == 3.5 and s.item() == 3.5 and bool(s)
    assert t.tolist() == j.tolist()
    assert [r.shape for r in t] == [(3,), (3,)]
    dst = tmx.nd.zeros((2, 3), ctx=CPU, dtype="float16")
    t.copyto(dst)
    assert dst.dtype == np.float16
    np.testing.assert_allclose(dst.asnumpy(), x, rtol=1e-3)
    moved = t.copyto(CPU)
    assert moved is not t and np.array_equal(moved.asnumpy(), x)
    assert t.as_in_context(CPU).wait_to_read().shape == (2, 3)
    assert isinstance(t.astorch(), torch.Tensor)
    assert torch.equal(torch.utils.dlpack.from_dlpack(t.to_dlpack_for_read()),
                       t.astorch())
    tmx.nd.waitall()
    with pytest.raises(ValueError):
        bool(t)


# ---------------------------------------------------------------------------
# indexing, assignment, in-place, out=
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [
    1, -1, slice(1, 3), (0, 2), (slice(None), 1), (Ellipsis, 0),
    (slice(None, None, -1), slice(0, 3, 2)),
])
def test_getitem(key):
    _both(lambda mx, a: a[key], _rand(4, 5))


def test_getitem_with_arrays():
    idx = np.array([3, 0, 1], np.float32)
    _both(lambda mx, a, i: [a[i], a[a > 0], a[(i, i)]], _rand(4, 5), idx)


@pytest.mark.parametrize("key,value", [
    (slice(None), 1.5), (Ellipsis, 2.0), (1, -1.0), ((0, 2), 9.0),
    ((slice(1, 3), slice(0, 2)), 0.0), (slice(None), "row"),
    ((slice(None), 1), "col"), ("mask", 0.0),
])
def test_setitem(key, value):
    x = _rand(3, 4)

    def fn(mx, a):
        k = a > 0 if key == "mask" else key
        v = mx.nd.array(np.arange(4, dtype=np.float32), ctx=a.context) \
            if value == "row" else \
            mx.nd.array(np.arange(3, dtype=np.float32), ctx=a.context) \
            if value == "col" else value
        a[k] = v
        return a

    _both(fn, x)


def test_slice_assign():
    _both(lambda mx, a, b: a.slice_assign(b, (0, 1), (2, 3)),
          _rand(3, 4), _rand(2, 2, seed=1))


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_inplace(op):
    def fn(mx, a, b):
        c = a
        exec("c %s b" % op)  # noqa: S102
        exec("c %s 2.0" % op)  # noqa: S102
        return c

    _both(fn, _rand(3, 4, lo=0.5, hi=2), _rand(3, 4, lo=0.5, hi=2, seed=1))


def test_inplace_keeps_the_array_identity():
    a = tmx.nd.array(_rand(2, 2), ctx=CPU)
    before = a
    a += 1
    assert a is before


def test_out_writes_into_given_buffers():
    def fn(mx, a, b):
        c = mx.nd.zeros((3, 4), ctx=a.context)
        r = mx.nd.broadcast_add(a, b, out=c)
        parts = [mx.nd.zeros((3, 2), ctx=a.context) for _ in range(2)]
        mx.nd.split(a, num_outputs=2, axis=1, out=parts)
        return [c, r, *parts]

    t = _both(fn, _rand(3, 4), _rand(3, 4, seed=1))
    assert t[0] is t[1]


def test_too_many_out_buffers_raise_in_both():
    for mx, ctx in ((jmx, None), (tmx, CPU)):
        a = mx.nd.ones((2, 2), ctx=ctx)
        bufs = [mx.nd.zeros((2, 2), ctx=ctx) for _ in range(2)]
        with pytest.raises(ValueError, match="output buffer"):
            mx.nd.broadcast_add(a, a, out=bufs)


def test_nd_namespace_refuses_unknown_ops():
    with pytest.raises(AttributeError):
        tmx.nd.no_such_op
    with pytest.raises(AttributeError):
        tmx.nd.contrib.no_such_op
    with pytest.raises(NotImplementedError, match="sparse"):
        tmx.nd.zeros((1,), ctx=CPU).tostype("csr")


def test_positional_attributes_and_named_inputs():
    _both(lambda mx, a: [mx.nd.swapaxes(a, 0, 1), mx.nd.clip(a, -1, 1),
                         mx.nd.sum(data=a, axis=1)], _rand(2, 3))


# ---------------------------------------------------------------------------
# random numbers: shapes, dtypes, moments (not jax.random's bits)
# ---------------------------------------------------------------------------


def test_random_shapes_dtypes_and_moments():
    r = tmx.nd.random
    r.seed(0)
    u = r.uniform(-1, 3, shape=(20000,), ctx=CPU)
    z = r.normal(2.0, 0.5, shape=(100, 200), ctx=CPU)
    n = r.randn(3, 4, ctx=CPU)
    k = r.randint(0, 5, shape=(1000,), ctx=CPU)
    j = jmx.nd.random
    for mine, ref in ((u, j.uniform(-1, 3, shape=(20000,))),
                      (z, j.normal(2.0, 0.5, shape=(100, 200))),
                      (n, j.randn(3, 4)), (k, j.randint(0, 5, shape=(1000,)))):
        assert mine.shape == ref.shape and mine.dtype == ref.dtype
    assert abs(u.asnumpy().mean() - 1.0) < 0.05
    assert u.asnumpy().min() >= -1 and u.asnumpy().max() < 3
    assert abs(z.asnumpy().mean() - 2.0) < 0.02
    assert abs(z.asnumpy().std() - 0.5) < 0.02
    assert set(np.unique(k.asnumpy())) == {0, 1, 2, 3, 4}
    assert r.uniform(shape=(2,), dtype="float16", ctx=CPU).dtype == np.float16


def test_random_seed_repeats():
    tmx.nd.random.seed(7)
    a = tmx.nd.random.normal(shape=(5,), ctx=CPU).asnumpy()
    tmx.random.seed(7)
    b = tmx.nd.random.normal(shape=(5,), ctx=CPU).asnumpy()
    c = tmx.nd.random.normal(shape=(5,), ctx=CPU).asnumpy()
    assert np.array_equal(a, b) and not np.array_equal(b, c)
    tmx.nd.random.seed(7, ctx=CPU)
    assert np.array_equal(tmx.nd.random.normal(shape=(5,), ctx=CPU)
                          .asnumpy(), a)


# ---------------------------------------------------------------------------
# contrib control flow
# ---------------------------------------------------------------------------


def test_control_flow():
    def fn(mx, a):
        c = mx.nd.contrib
        out, state = c.foreach(lambda x, s: (x * s, s + x), a, a[0] * 0 + 1)
        w_out, w_vars = c.while_loop(lambda i, s: i < 3,
                                     lambda i, s: (s * 2, (i + 1, s + 1)),
                                     [a[0, 0] * 0, a[0]], max_iterations=5)
        yes = c.cond(a.sum() > -100, lambda: a + 1, lambda: a - 1)
        return [out, state, w_out, *w_vars, yes]

    _both(fn, _rand(4, 3))
