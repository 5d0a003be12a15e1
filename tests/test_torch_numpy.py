"""The port's ``mx.np``, ``mx.np.linalg``, ``mx.np.random``, ``mx.npx`` and
``mx.util`` against the JAX package's, on the CPU.

One parametrised test covers every name of the reference's two dispatch
sets: each case builds the same numpy inputs as NDArrays of each package
and calls the function by name.  Outputs are held equal in structure,
shape and dtype, integer and boolean values equal and floating values
within 1e-6 of the output's largest magnitude (at least 1e-6); for a
name of the differentiable set the floating inputs get ``attach_grad``,
the call runs under ``autograd.record()`` and a fixed random
projection of its floating outputs is back-propagated on each package's
tape: the gradients are held the same way.  A name this process's
``jax.numpy`` lacks (the reference resolves it at run time or not) is
held against numpy itself, and so are the string forms
(``array2string``, ``array_repr``, ``array_str``): the reference formats
each float32 element through a float64 scalar and names its class
``ArrayImpl``.
"""
import builtins
import os
import sys
import warnings

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import context

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from np_surface_cases import (CASES, LINALG, N, RANDOM, SPD,  # noqa: E402
                              _f, build, case_name)

TOL = 1e-6

def _sets():
    jnp_mod = jmx.numpy
    return jnp_mod._DIFFERENTIABLE, jnp_mod._NONDIFF


def test_every_name_has_a_case():
    diff, quiet = _sets()
    names = {case_name(c) for c in CASES}
    assert (diff | quiet) - {"copyto"} <= names, sorted(
        (diff | quiet) - {"copyto"} - names)
    tdiff, tquiet = tmx.numpy._DIFFERENTIABLE, tmx.numpy._NONDIFF
    assert tdiff == diff and tquiet == quiet


def _resolves(name):
    """Whether the reference resolves ``name`` (its catch-all reads this
    process's ``jax.numpy``)."""
    try:
        getattr(jmx.numpy, name)
    except AttributeError:
        return False
    return True


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)
    else:
        yield out


def _as_numpy(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return v


def _floating(a):
    return isinstance(a, onp.ndarray) and onp.issubdtype(a.dtype,
                                                         onp.floating)


def _close(got, want, what):
    if isinstance(want, onp.ndarray) or isinstance(got, onp.ndarray):
        got, want = onp.asarray(got), onp.asarray(want)
        assert got.shape == want.shape, (what, got.shape, want.shape)
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        if not _floating(want):
            onp.testing.assert_array_equal(got, want, err_msg=what)
            return
        if onp.array_equal(got, want, equal_nan=True):
            return
        w = want.astype(onp.float64)
        assert onp.array_equal(onp.isnan(got), onp.isnan(want)), what
        finite = onp.isfinite(w)
        assert onp.array_equal(got[~finite], want[~finite],
                               equal_nan=True), what
        err = float(onp.abs(got[finite] - w[finite]).max()) \
            if finite.any() else 0.0
        limit = TOL * max(1.0, float(onp.abs(w[finite]).max())
                          if finite.any() else 0.0)
        assert err <= limit, "%s: max abs err %g over %g" % (what, err,
                                                              limit)
        return
    assert got == want, (what, got, want)


def _run(mod, case, ndarray, record):
    """The case's outputs on ``mod`` (an ``mx.np``), with the gradients of
    its floating inputs where ``record``."""
    live = []

    def A(x):  # noqa: N802
        x = onp.asarray(x)
        a = mod.array(x, dtype=x.dtype)
        if onp.issubdtype(x.dtype, onp.floating):
            live.append(a)
        return a

    args, kwargs = build(CASES, case, A)
    fn = getattr(mod, case_name(case))
    if mod is jmx.numpy and hasattr(builtins, case_name(case)):
        # the reference caches what it resolves as a module global, which
        # shadows the builtin ``any`` its recorder calls (ROADMAP, Noted
        # in the reference): drop the cached name again
        vars(mod).pop(case_name(case), None)
    if not record or not live:
        return [_as_numpy(o) for o in _leaves(fn(*args, **kwargs))], None
    for a in live:
        a.attach_grad()
    autograd = jautograd if mod is jmx.numpy else tautograd
    rng = onp.random.RandomState(sum(map(ord, case)))
    with autograd.record():
        out = fn(*args, **kwargs)
        outs = [o for o in _leaves(out) if isinstance(o, ndarray)]
        loss = None
        for o in outs:
            if onp.issubdtype(onp.asarray(o.asnumpy()).dtype, onp.floating):
                c = mod.array(rng.uniform(-1, 1, o.shape).astype(
                    o.asnumpy().dtype))
                term = mod.sum(mod.multiply(o, c))
                loss = term if loss is None else mod.add(loss, term)
    vals = [_as_numpy(o) for o in _leaves(out)]
    if loss is None:
        return vals, None
    try:
        loss.backward()
    except ValueError:
        # the port records nothing where no output depends on an input
        # (``imag`` of a real array); every gradient is then 0
        assert mod is tmx.numpy
        return vals, [onp.zeros(a.shape, onp.float32) for a in live]
    return vals, [a.grad.asnumpy() for a in live]


@pytest.mark.parametrize("case", sorted(CASES))
def test_np_matches_reference(case):
    name = case_name(case)
    diff, _ = _sets()
    record = name in diff
    with context.device_scope("cpu"):
        got, got_g = _run(tmx.numpy, case, tmx.NDArray, record)
    if not _resolves(name) or name in _NUMPY_FORMAT:
        # this jax.numpy lacks it: hold the port to numpy itself
        want = _numpy_reference(case)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s output %d" % (case, i))
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, want_g = _run(jmx.numpy, case, jmx.nd.NDArray, record)
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "%s output %d" % (case, i))
    if want_g is not None:
        assert got_g is not None, "%s: the port recorded nothing" % case
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            _close(g, w, "%s gradient %d" % (case, i))


#: string forms held to numpy's own: the reference formats each float32
#: element through a float64 scalar (ROADMAP, Noted in the reference)
_NUMPY_FORMAT = ("array2string", "array_repr", "array_str")


def _numpy_reference(case):
    name = case_name(case)
    args, kwargs = build(CASES, case, lambda x: onp.array(x))
    fn = {"flatten": onp.ravel, "ascontiguousarray": onp.ascontiguousarray,
          "trapz": onp.trapezoid}.get(name) or getattr(onp, name)
    out = fn(*args, **kwargs)
    if name == "trapz":
        out = onp.asarray(out, onp.float32)
    return [o for o in _leaves(out)]


def test_copyto_writes_in_place():
    with context.device_scope("cpu"):
        dst = tmx.np.array(onp.zeros((2, 3), onp.float32))
        tmx.np.copyto(dst, tmx.np.array(onp.arange(3, dtype=onp.int32)))
        onp.testing.assert_array_equal(dst.asnumpy(), [[0, 1, 2]] * 2)
        assert dst.dtype == onp.float32
        tmx.np.copyto(dst, 5.0, where=tmx.np.array(onp.array(
            [[True, False, True]] * 2)))
        onp.testing.assert_array_equal(dst.asnumpy(), [[5, 1, 5]] * 2)


def test_constructors_dtypes_match_reference():
    cases = [("zeros", ((2, 3),), {}), ("ones", ((4,),), {"dtype": "int32"}),
             ("full", ((2,), 1.5), {}), ("full", ((2,), 3), {}),
             ("arange", (5,), {}), ("arange", (0.5, 3.0), {}),
             ("arange", (1, 7, 2), {"dtype": "float32"}),
             ("eye", (3,), {"k": 1}), ("eye", (2, 4), {"dtype": "int32"}),
             ("array", ([1.5, 2.0],), {}), ("array", ([1, 2],), {}),
             ("array", (onp.ones(2, onp.float64),), {})]
    for name, args, kwargs in cases:
        with context.device_scope("cpu"):
            got = getattr(tmx.np, name)(*args, **kwargs).asnumpy()
        want = getattr(jmx.np, name)(*args, **kwargs).asnumpy()
        _close(got, want, name)


def test_other_names_raise_naming_the_roadmap():
    for name in ("angle", "linspace", "polyval"):
        with pytest.raises(AttributeError, match="A13"):
            getattr(tmx.np, name)


# -- the reference's test_numpy_autograd.py behaviours on the port -----------

def _attach(x):
    x.attach_grad()
    return x


def test_np_only_mlp_grad_matches_reference():
    rng = onp.random.RandomState(0)
    w1v = rng.normal(size=(4, 8)).astype(onp.float32)
    w2v = rng.normal(size=(8, 1)).astype(onp.float32)
    xv = rng.normal(size=(5, 4)).astype(onp.float32)
    grads = []
    for mod, ag in ((jmx.np, jautograd), (tmx.np, tautograd)):
        with context.device_scope("cpu"):
            w1, w2 = _attach(mod.array(w1v)), _attach(mod.array(w2v))
            x = mod.array(xv)
            with ag.record():
                loss = mod.sum(mod.matmul(mod.tanh(mod.matmul(x, w1)), w2))
            loss.backward()
            grads.append((w1.grad.asnumpy(), w2.grad.asnumpy()))
    for g, w in zip(grads[1], grads[0]):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_unknown_name_is_loud_and_quiet_set_is_silent():
    """The reference warns once when a name outside its sets is used
    under recording; the port has no such pass-through and raises.  The
    quiet set is silent under recording in both."""
    with context.device_scope("cpu"):
        x = _attach(tmx.np.array(onp.ones(3, onp.float32)))
        with tautograd.record():
            with pytest.raises(AttributeError):
                tmx.np.angle(x)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                idx = tmx.np.argmax(x)
        assert int(idx.asnumpy()) == 0
        assert not tautograd.requires_grad(idx)


def test_passthrough_copysign_warns_once_and_matches_reference():
    """``copysign`` is outside both sets: the reference resolves it by its
    catch-all (no recording, one warning under recording); so does the
    port."""
    a, b = onp.array([1.5, -2.0, 3.0], onp.float32), onp.array(
        [-1.0, 1.0, -0.0], onp.float32)
    want = jmx.np.copysign(jmx.np.array(a), jmx.np.array(b)).asnumpy()
    with context.device_scope("cpu"):
        x = _attach(tmx.np.array(a))
        tmx.np._WARNED_PASSTHROUGH.discard("copysign")
        with tautograd.record():
            with pytest.warns(UserWarning, match="not in the differentiable"):
                got = tmx.np.copysign(x, tmx.np.array(b))
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                tmx.np.copysign(x, tmx.np.array(b))
    assert not tautograd.requires_grad(got)
    _close(got.asnumpy(), want, "copysign")


def test_dispatch_protocol_surface_matches_reference():
    """The reference's ``test_np_dispatch_protocol_surface`` list on both
    packages: the same values, shapes and dtypes."""
    a0 = onp.arange(12, dtype="float32").reshape(3, 4) + 1.0
    v0 = onp.array([1.0, 2.0, 3.0], "float32")
    unary = ("abs absolute arccosh arcsinh arctan arctanh argmax argmin "
             "ceil cos cosh cumsum exp expm1 floor log log10 log1p log2 "
             "mean negative prod ravel reciprocal sign sin sinh sqrt "
             "square std sum tan tanh transpose trunc var zeros_like "
             "ones_like copy diff").split()
    binary = ("add subtract multiply divide power maximum minimum "
              "arctan2 hypot copysign").split()
    outs = []
    for mod in (jmx.np, tmx.np):
        with context.device_scope("cpu"):
            a, v = mod.array(a0), mod.array(v0)
            got = [getattr(mod, n)(a) for n in unary]
            got += [getattr(mod, n)(a, a) for n in binary]
            got += [mod.concatenate([a, a], axis=0), mod.stack([a, a]),
                    mod.split(a, 2, axis=1)[0], mod.reshape(a, (4, 3)),
                    mod.squeeze(mod.expand_dims(a, 0), 0),
                    mod.where(a > 6, a, -a), mod.tile(v, 2), mod.flip(a, 0),
                    mod.dot(a, mod.transpose(a)),
                    mod.tensordot(a, a, axes=([1], [1])),
                    mod.einsum("ij,kj->ik", a, a), mod.linalg.norm(a),
                    mod.unique(mod.array(onp.array([1.0, 1.0, 2.0]))),
                    mod.argsort(v), mod.clip(a, 2.0, 5.0)]
            outs.append([o.asnumpy() for o in got])
    for i, (g, w) in enumerate(zip(outs[1], outs[0])):
        _close(g, w, "surface %d" % i)


def test_np_not_recording_is_plain():
    with context.device_scope("cpu"):
        x = _attach(tmx.np.array(onp.ones((2, 2), onp.float32)))
        y = tmx.np.matmul(x, x)
    assert isinstance(y, tmx.NDArray) and not y._data.requires_grad
    onp.testing.assert_allclose(y.asnumpy(), onp.full((2, 2), 2.0))


def test_np_split_single_section_grad():
    with context.device_scope("cpu"):
        x = _attach(tmx.np.array(onp.arange(4, dtype=onp.float32)))
        with tautograd.record():
            parts = tmx.np.split(x, 1)
            loss = tmx.np.sum(parts[0] * 3.0)
        loss.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [3, 3, 3, 3])


# -- np.linalg, np.random, npx, util ----------------------------------------

@pytest.mark.parametrize("case", sorted(LINALG))
def test_linalg_matches_reference(case):
    name = case.split("-")[0]
    outs = []
    for mod in (jmx.np, tmx.np):
        with context.device_scope("cpu"):
            args, kwargs = build(LINALG, case, lambda x, m=mod: m.array(x))
            out = getattr(mod.linalg, name)(*args, **kwargs)
            outs.append([_as_numpy(o) for o in _leaves(out)])
    want, got = outs
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = onp.asarray(g), onp.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.dtype, w.dtype)
        onp.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["svd", "qr", "eigh", "eig", "eigvals"])
def test_linalg_factors_up_to_sign(name):
    """Factors with a sign or phase freedom: products and magnitudes."""
    a = SPD if name in ("eigh", "eig", "eigvals") else _f(5, 3)
    with context.device_scope("cpu"):
        got = getattr(tmx.np.linalg, name)(tmx.np.array(a))
    want = getattr(jmx.np.linalg, name)(jmx.np.array(a))
    got = [_as_numpy(o) for o in _leaves(got)]
    want = [_as_numpy(o) for o in _leaves(want)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    if name == "svd":
        u, s, vt = got
        onp.testing.assert_allclose((u[:, :3] * s) @ vt, a, atol=1e-5)
        onp.testing.assert_allclose(s, want[1], rtol=1e-5)
    elif name == "qr":
        onp.testing.assert_allclose(got[0] @ got[1], a, atol=1e-5)
        onp.testing.assert_allclose(onp.abs(got[1]), onp.abs(want[1]),
                                    atol=1e-5)
    elif name == "eigh":
        onp.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        onp.testing.assert_allclose(onp.abs(got[1]), onp.abs(want[1]),
                                    atol=1e-4)
    else:
        vals = got[0]
        onp.testing.assert_allclose(onp.sort(vals.real), onp.sort(
            want[0].real), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_shape_dtype_moments(name):
    kwargs, mean, var = RANDOM[name]
    jmx.random.seed(0)
    want = getattr(jmx.np.random, name)(**kwargs)
    tmx.random.seed(24)
    got = getattr(tmx.np.random, name)(**dict(kwargs, ctx="cpu"))
    assert got.shape == want.shape
    assert str(got.asnumpy().dtype) == str(want.asnumpy().dtype), (
        got.asnumpy().dtype, want.asnumpy().dtype)
    x = got.asnumpy().astype(onp.float64)
    assert abs(x.mean() - mean) <= 6 * onp.sqrt(var / N), (x.mean(), mean)
    assert abs(x.var() - var) <= 6 * onp.sqrt(8 * var ** 2 / N), (x.var(),
                                                                  var)


def test_random_rest_of_the_surface():
    tmx.np.random.seed(3)
    with context.device_scope("cpu"):
        a = tmx.np.random.rand(3, 2)
        b = tmx.np.random.randn(4)
        tmx.np.random.seed(3)
        assert onp.array_equal(tmx.np.random.rand(3, 2).asnumpy(),
                               a.asnumpy())
        rows = tmx.np.array(onp.arange(20, dtype=onp.float32).reshape(10, 2))
        tmx.np.random.shuffle(rows)
        picked = tmx.np.random.choice(rows, size=4, replace=False)
        counts = tmx.np.random.multinomial(
            50, onp.array([0.2, 0.3, 0.5]), size=(2,))
    for got, want in ((a, jmx.np.random.rand(3, 2)),
                      (b, jmx.np.random.randn(4)),
                      (counts, jmx.np.random.multinomial(
                          50, onp.array([0.2, 0.3, 0.5]), size=(2,)))):
        assert got.shape == want.shape
        assert str(got.asnumpy().dtype) == str(want.asnumpy().dtype)
    assert sorted(map(tuple, rows.asnumpy())) == [(2 * i, 2 * i + 1)
                                                  for i in range(10)]
    assert picked.shape == (4, 2)
    assert onp.all(counts.asnumpy().sum(axis=1) == 50)


def test_npx_matches_reference():
    rng = onp.random.RandomState(5)
    x = rng.normal(size=(2, 3, 6, 6)).astype(onp.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(onp.float32)
    g, b = rng.uniform(0.5, 1.5, 4).astype(onp.float32), rng.normal(
        size=4).astype(onp.float32)
    fw = rng.normal(size=(5, 4)).astype(onp.float32)
    lab = onp.array([1, 4], onp.float32)
    res = []
    for mx_, ag in ((jmx, jautograd), (tmx, tautograd)):
        with context.device_scope("cpu"):
            np_, npx = mx_.np, mx_.npx
            xs, ws = np_.array(x), _attach(np_.array(w))
            gs, bs = _attach(np_.array(g)), _attach(np_.array(b))
            fws = _attach(np_.array(fw))
            rm, rv = np_.zeros((4,)), np_.ones((4,))
            with ag.record():
                h = npx.convolution(xs, ws, None, kernel=(3, 3),
                                    num_filter=4, no_bias=True, pad=(1, 1))
                h = npx.batch_norm(h, gs, bs, rm, rv)
                h = npx.relu(h)
                h = npx.pooling(h, kernel=(2, 2), stride=(2, 2),
                                pool_type="max")
                h = npx.pooling(h, kernel=(3, 3), global_pool=True,
                                pool_type="avg")
                h = npx.fully_connected(h, fws, None, num_hidden=5,
                                        no_bias=True)
                lp = npx.log_softmax(h)
                loss = -np_.mean(npx.pick(lp, np_.array(lab)))
            loss.backward()
            extra = [npx.softmax(h), npx.sigmoid(h),
                     npx.one_hot(np_.array(lab), 5),
                     npx.topk(h, k=2),
                     npx.batch_dot(np_.array(x[0, :2, :2]),
                                   np_.array(x[1, :2, :, :2])),
                     npx.reshape_like(np_.array(x[0, 0]),
                                      np_.array(onp.zeros((4, 9)))),
                     npx.gamma(np_.array(onp.array([1.5, 3.0], onp.float32)))]
            res.append([v.asnumpy() for v in [loss, h, ws.grad, gs.grad,
                                               bs.grad, fws.grad] + extra])
    for i, (gv, wv) in enumerate(zip(res[1], res[0])):
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, i
        onp.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5,
                                    err_msg=str(i))


def test_util_scopes_and_switches(tmp_path, monkeypatch):
    from incubator_mxnet_tpu_torch import util

    assert set(util.__all__) == set(jmx.util.__all__)
    assert tmx.set_np is util.set_np and tmx.npx.set_np is util.set_np
    assert not util.is_np_array() and not util.is_np_shape()
    with util.np_shape():
        assert util.is_np_shape() and not util.is_np_array()
        with util.np_array():
            assert util.is_np_array()
        assert not util.is_np_array()
    assert not util.is_np_shape()

    @util.use_np
    def both():
        return util.is_np_shape(), util.is_np_array()

    assert both() == (True, True) and not util.is_np_array()
    tmx.set_np()
    try:
        assert tmx.is_np_array() and tmx.npx.is_np_shape()
    finally:
        tmx.reset_np()
    assert not tmx.is_np_array()
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    assert util.data_dir() == jmx.util.data_dir() == str(tmp_path)
    from incubator_mxnet_tpu_torch.gluon.data.vision import datasets

    assert datasets.data_dir is util.data_dir
    util.setenv("MXNET_PORT_TEST_VAR", "1")
    assert util.getenv("MXNET_PORT_TEST_VAR") == "1"
    os.environ.pop("MXNET_PORT_TEST_VAR")
    util.makedirs(str(tmp_path / "a" / "b"))
    util.makedirs(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()


# -- the mx.np-written ResNet step (chip_smoke.py phase 3v) ------------------

def _resnet_np():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "example", "numpy", "resnet_np.py")
    spec = importlib.util.spec_from_file_location("resnet_np", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    return float(onp.abs(got - want).max()) / max(1.0, float(
        onp.abs(want).max()))


def test_np_resnet_step_matches_reference():
    """Phase 3v's forward, loss, backward, running stats and AdamW update
    written once (``example/numpy/resnet_np.py``) run on both packages
    from the same weights: the first two stages of ``resnet18_v1`` at 32
    px, batch 4, 10 classes.  The logits, the loss and the running stats
    within 1e-5; of the gradients the well-conditioned output layer's
    (ROADMAP, Comparing steps: the rest of a zoo net's at this size is
    ill-conditioned); the update at lr 1e-3 fed the reference's
    gradients within 1e-6."""
    from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    from incubator_mxnet_tpu_torch import convert, gluon as tgluon
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

    ex = _resnet_np()
    spec = ("basic", (1, 1), (64, 64, 128))
    jmx.random.seed(0)
    jnet = jres.ResNetV1(jres.BasicBlockV1, [1, 1], [64, 64, 128],
                         classes=10)
    jnet.initialize(init=jmx.init.Xavier())
    jnet.shape_init((1, 3, 32, 32))
    tnet = tres.ResNetV1(tres.BasicBlockV1, [1, 1], [64, 64, 128],
                         classes=10, device="cpu")
    tgluon.shape_init(tnet, (1, 3, 32, 32))
    convert.params_from_jax(tnet, [p.data().asnumpy()
                                   for p in jnet.collect_params().values()])
    images, labels = ex.synthetic_batch(4, 44, 40, 10, 0)
    jx = ex.preprocess(jmx, jmx.nd.array(images, dtype="uint8"), 36, 32)
    with context.device_scope("cpu"):
        tx = ex.preprocess(tmx, tmx.nd.array(images, dtype="uint8"), 36, 32)
    # the resize truncates to uint8: an f32 rounding may land one level
    # apart (the ops' own test holds that); the steps share the input
    assert tx.shape == jx.shape == (4, 3, 32, 32)
    assert onp.abs(tx.asnumpy() - jx.asnumpy()).max() <= 1.01 / 255 / 0.224
    x = jx.asnumpy()

    reads = []
    for mx_, ctx in ((jmx, None), (tmx, "cpu")):
        with context.device_scope("cpu"):
            state = ex.NpState(mx_, jnet if mx_ is jmx else tnet, ctx=ctx)
            xs, ys = mx_.np.array(x, ctx=ctx), mx_.np.array(labels, ctx=ctx)
            with mx_.autograd.record():
                logits, stats = ex.forward(mx_, state.named, xs, spec)
                loss = ex.cross_entropy(mx_, logits, ys)
            loss.backward()
            ex.update_running_stats(mx_, stats)
            reads.append(dict(
                state=state, logits=logits.asnumpy(),
                loss=float(loss.asnumpy()),
                stats=[(rm.asnumpy(), rv.asnumpy()) for rm, rv, _, _ in stats],
                grads=[state.named[i][1].grad.asnumpy()
                       for i in state.trained]))
    want, got = reads
    assert [n for n, _ in got["state"].named] == \
        [n for n, _ in want["state"].named]
    assert _rel(got["logits"], want["logits"]) <= 1e-5
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1, abs(want["loss"]))
    assert len(got["stats"]) == len(want["stats"]) == 6
    for (gm, gv), (wm, wv) in zip(got["stats"], want["stats"]):
        assert _rel(gm, wm) <= 1e-5 and _rel(gv, wv) <= 1e-5
    for g, w in zip(got["grads"][-2:], want["grads"][-2:]):  # the Dense
        assert _rel(g, w) <= 1e-5

    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
    jouts = ex.adamw_update(jmx, want["state"], 1e-3, 1e-4, **hyper)
    with context.device_scope("cpu"):
        touts = ex.adamw_update(
            tmx, got["state"], 1e-3, 1e-4,
            grads=[tmx.np.array(g, ctx="cpu") for g in want["grads"]],
            **hyper)
    assert len(touts) == len(jouts) == 3 * len(want["grads"])
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        assert _rel(t.asnumpy(), j.asnumpy()) <= 1e-6
