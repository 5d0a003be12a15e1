"""The ``la_op`` family (``ops/linalg.py``, ``mx.nd.linalg``,
``mx.sym.linalg``) against the JAX package's, on the CPU.

Each op's forward and its gradient for a random cotangent against the
reference op (``jax.vjp`` of its registered function) on the same numpy
inputs, f32, at the cases of the reference's ``tests/test_linalg_np.py``
and their options (transposes, ``rightside``, upper triangles, offsets,
batches).  ``syevd``'s eigenvectors are defined up to sign, so its case
compares ``U * U`` and the eigenvalues.  Tolerance: 1e-4 relative to each
array's largest magnitude (factorizations by other LAPACK routines in
another order), 1e-5 absolute floor.  Then the namespaces: the names of
``mx.nd.linalg`` and ``mx.sym.linalg`` are the reference's, a
``mx.sym.linalg`` graph is the reference's JSON and runs, and
``mx.nd.linalg`` records for autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()


def _spd(n, batch=(), seed=0):
    rng = np.random.RandomState(seed)
    a = rng.normal(size=batch + (n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _rand(*shape, seed=1):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _tril(n, seed=2):
    return np.tril(_rand(n, n, seed=seed) + 3 * np.eye(n)).astype(np.float32)


def _sq(u, lam):
    return u * u, lam


# (op, inputs, attrs, post-processing of the outputs on both sides)
CASES = [
    ("_linalg_gemm", lambda: [_rand(2, 3, 4), _rand(2, 4, 5, seed=2),
                              _rand(2, 3, 5, seed=3)],
     dict(alpha=2.0, beta=0.5), None),
    ("_linalg_gemm", lambda: [_rand(2, 4, 3), _rand(2, 5, 4, seed=2),
                              _rand(2, 3, 5, seed=3)],
     dict(transpose_a=True, transpose_b=True), None),
    ("_linalg_gemm2", lambda: [_rand(2, 3, 4), _rand(2, 4, 5, seed=2)],
     dict(alpha=0.5), None),
    ("_linalg_gemm2", lambda: [_rand(3, 4), _rand(3, 4, seed=2)],
     dict(transpose_b=True), None),
    ("_linalg_potrf", lambda: [_spd(4, (2,))], {}, None),
    ("_linalg_potri", lambda: [np.linalg.cholesky(_spd(4))], {}, None),
    ("_linalg_trmm", lambda: [_tril(3), _rand(3, 4)], {}, None),
    ("_linalg_trmm", lambda: [_tril(3).T.copy(), _rand(4, 3)],
     dict(transpose=True, rightside=True, lower=False, alpha=1.5), None),
    ("_linalg_trsm", lambda: [_tril(3), _rand(3, 4)], {}, None),
    ("_linalg_trsm", lambda: [_tril(3), _rand(4, 3)],
     dict(transpose=True, rightside=True, alpha=2.0), None),
    ("_linalg_trsm", lambda: [_tril(3).T.copy(), _rand(3, 4)],
     dict(lower=False), None),
    ("_linalg_syrk", lambda: [_rand(3, 4)], {}, None),
    ("_linalg_syrk", lambda: [_rand(3, 4)], dict(transpose=True,
                                                 alpha=0.5), None),
    ("_linalg_gelqf", lambda: [_rand(3, 5)], {}, None),
    ("_linalg_syevd", lambda: [_spd(4, seed=6)], {}, _sq),
    ("_linalg_sumlogdiag", lambda: [np.linalg.cholesky(_spd(4, seed=5))],
     {}, None),
    ("_linalg_extractdiag", lambda: [_rand(2, 4, 4)], {}, None),
    ("_linalg_extractdiag", lambda: [_rand(4, 4)], dict(offset=1), None),
    ("_linalg_makediag", lambda: [_rand(2, 3)], {}, None),
    ("_linalg_makediag", lambda: [_rand(3)], dict(offset=-1), None),
    ("_linalg_extracttrian", lambda: [_rand(4, 4)], {}, None),
    ("_linalg_extracttrian", lambda: [_rand(2, 4, 4)],
     dict(lower=False, offset=1), None),
    ("_linalg_maketrian", lambda: [_rand(10)], {}, None),
    ("_linalg_maketrian", lambda: [_rand(2, 6)], dict(lower=False,
                                                      offset=1), None),
    ("_linalg_inverse", lambda: [_spd(3, seed=7)], {}, None),
    ("_linalg_det", lambda: [_spd(3, (2,), seed=7)], {}, None),
    ("_linalg_slogdet", lambda: [_spd(3, seed=7) - 4 * np.eye(3,
                                                              dtype=np.float32)],
     {}, None),
    ("_npi_einsum", lambda: [_rand(3, 4), _rand(4, 5, seed=2)],
     dict(subscripts="ij,jk->ik"), None),
    ("_npi_tensordot", lambda: [_rand(3, 4), _rand(4, 5, seed=2)],
     dict(axes=1), None),
    ("_npi_tensordot", lambda: [_rand(3, 4, 2), _rand(4, 3, 5, seed=2)],
     dict(axes=((0, 1), (1, 0))), None),
]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=max(1e-4 * scale,
                                                           1e-5),
                               err_msg=what)


def _listed(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_op_forward_and_gradient(case):
    name, make, attrs, post = CASES[case]
    inputs = make()
    post = post or (lambda *o: o)

    def jfn(*xs):
        return tuple(post(*_listed(jreg.get_op(name).fn(*xs, **attrs))))

    jout, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs])
    rng = np.random.RandomState(9)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))

    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = post(*_listed(treg.get_op(name).fn(*xs, **attrs)))
    assert len(tout) == len(jout)
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert tuple(t.shape) == j.shape
        _close(t.detach().numpy(), np.asarray(j), "output %d" % i)
    live = [(t, torch.from_numpy(c)) for t, c in zip(tout, cots)
            if t.requires_grad]
    tgrads = torch.autograd.grad([t for t, _ in live], xs,
                                 [c for _, c in live], allow_unused=True)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        t = np.zeros(inputs[i].shape, np.float32) if t is None else t.numpy()
        _close(t, np.asarray(j), "gradient %d" % i)


LINALG = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
          "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
          "extracttrian", "maketrian", "inverse", "det", "slogdet"]


def test_namespaces_match_reference():
    assert tmx.nd.linalg.__all__ == jmx.nd.linalg.__all__ == LINALG
    assert tmx.sym.linalg.__all__ == jmx.sym.linalg.__all__
    for name in LINALG:
        assert callable(getattr(tmx.nd.linalg, name))
        assert callable(getattr(tmx.sym.linalg, name))


def test_nd_linalg_runs_and_records():
    """``nd.linalg.potrf`` then ``sumlogdiag`` under ``record()``: the
    gradient ``0.5 * A^-1`` (the reference's test)."""
    S = _spd(3, seed=8)
    x = tmx.nd.array(S, ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.linalg.sumlogdiag(tmx.nd.linalg.potrf(x))
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 0.5 * np.linalg.inv(S),
                               rtol=1e-2, atol=1e-3)
    L, Q = tmx.nd.linalg.gelqf(tmx.nd.array(_rand(3, 5), ctx=CPU))
    np.testing.assert_allclose(L.asnumpy() @ Q.asnumpy(), _rand(3, 5),
                               rtol=0, atol=1e-4)
    assert np.all(np.diag(L.asnumpy()) >= 0)


def _sym_graph(S):
    """The ops without ``alpha``: ``PARAM_INPUT_NAMES`` holds PReLU's
    ``alpha``, so in both packages a symbolic ``gemm``, ``gemm2``,
    ``trmm``, ``trsm`` or ``syrk`` also composes a ``<node>_alpha``
    argument (ROADMAP Queue C)."""
    a, b = S.var("a"), S.var("b")
    return S.Group([S.linalg.sumlogdiag(S.linalg.potrf(a)),
                    S.linalg.gelqf(b)[0], S.linalg.syevd(a)[1],
                    S.linalg.slogdet(a)[1], S.linalg.inverse(a),
                    S.linalg.det(a), S.linalg.extractdiag(a, offset=1)])


def test_sym_linalg_matches_reference_and_runs():
    with jmx.name.NameManager():
        js = _sym_graph(jmx.sym)
    with tmx.name.NameManager():
        ts = _sym_graph(tmx.sym)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments() == ["a", "b"]
    assert ts.list_outputs() == js.list_outputs()
    a, b = _spd(4, seed=9), _rand(3, 5)
    shapes = dict(a=a.shape, b=b.shape)
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    tout = ts.bind(CPU, {"a": tmx.nd.array(a, ctx=CPU),
                         "b": tmx.nd.array(b, ctx=CPU)}).forward()
    jout = js.bind(jmx.cpu(), {"a": jmx.nd.array(a),
                               "b": jmx.nd.array(b)}).forward()
    for t, j in zip(tout, jout):
        _close(t.asnumpy(), j.asnumpy(), "sym output")
