"""The port's NumPy-internal op names and samplers against the JAX
package's, on the CPU: ``ops/npi.py``'s ``_npi_*``/``_np_*``/``_npx_*``
names with the other names it registers, and the samplers of
``ops/random_ops.py``.

The registry guard holds every name to the reference's arity, outputs,
flags and canonical op.  Each body's case feeds the same numpy arrays
to both registries: outputs are held within 1e-6 of the output's largest
magnitude (at least 1e-6 absolute) with equal dtypes, integer outputs
equal, and for a differentiable op the gradient of a fixed random
projection of its floating outputs likewise.  The reference side of the
traceable cases runs in one ``jax.jit``; ops the reference marks
``no_trace`` run eagerly.  The SVD is held by ``u * s @ vt`` and by the
factors' magnitudes (the solvers' signs differ).  The samplers' numbers
are not ``jax.random``'s: they are held by shape, dtype and moments,
within 6 standard errors over a fixed seed.
"""
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu  # noqa: F401  (registers the ops)
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch  # noqa: F401
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch.ops import registry as treg

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0] + "/tools")
from np_surface_cases import N, SAMPLERS as SAMPLER_ROWS  # noqa: E402

TOL = 1e-6

#: names of ``_npi_*``/``_np_*``/``_npx_*`` form that wait for the port of
#: the reference's ``ops/parity_tail.py``
PARITY_TAIL = ("_np_all", "_np_any", "_npx_quadratic")

#: the other names ``ops/npi.py`` registers
NPI_OTHERS = (
    "arctan2", "around", "average", "bincount", "copysign", "ldexp", "lcm",
    "diff", "rot90", "roll", "moveaxis", "trace", "diagonal", "diagflat",
    "std", "var", "vstack", "dstack", "column_stack", "concatenate",
    "linalg_solve", "linalg_gesvd", "bitwise_or", "bitwise_xor",
    "_image_to_tensor", "to_tensor", "_image_normalize", "_image_resize",
    "_image_crop", "cast_storage", "_square_sum", "_multi_adamw_update",
    "_multi_mp_adamw_update", "_contrib_calibrate_entropy",
    "_rnn_param_concat", "_contrib_SparseEmbedding")

#: the samplers of ``ops/random_ops.py`` new in the port, with aliases
SAMPLERS = (
    "_random_gamma", "random_gamma", "_random_exponential",
    "random_exponential", "_random_poisson", "random_poisson",
    "_random_negative_binomial", "random_negative_binomial",
    "_random_generalized_negative_binomial",
    "random_generalized_negative_binomial", "_sample_multinomial",
    "sample_multinomial", "multinomial", "_sample_uniform",
    "sample_uniform", "_sample_normal", "sample_normal", "_shuffle",
    "shuffle")


def _npi_names():
    return sorted(n for n in jreg.OPS
                  if n.startswith(("_npi_", "_np_", "_npx_"))
                  and n not in PARITY_TAIL)


#: (canonical op, attribute): where an op the port had before this slice
#: records an attribute its own way.  The port's ``SliceChannel`` says 1
#: output: its symbol layer reads the count from the ``num_outputs``
#: attribute of an op whose own count is 1.
PORT_CONVENTIONS = {("SliceChannel", "num_outputs"): 1}


@pytest.mark.parametrize("name", _npi_names() + list(NPI_OTHERS)
                         + list(SAMPLERS))
def test_registry_name_matches_reference(name):
    jop = jreg.OPS[name]
    top = treg.OPS.get(name)
    assert top is not None, "%s is not registered in the port" % name
    assert top.name == jop.name, (top.name, jop.name)
    for attr in ("num_inputs", "num_outputs", "differentiable", "no_trace"):
        want = PORT_CONVENTIONS.get((jop.name, attr), getattr(jop, attr))
        assert getattr(top, attr) == want, attr


def test_registry_counts():
    """137 ``_npi_*``/``_np_*``/``_npx_*`` names came over in this slice
    (the port had ``_npi_einsum``, ``_npi_tensordot``, ``_np_nonzero``
    and ``_np_unique``)."""
    names = _npi_names()
    assert len(names) == 141
    assert len(set(names) - {"_npi_einsum", "_npi_tensordot",
                             "_np_nonzero", "_np_unique"}) == 137


_RNG = np.random.RandomState(24)


def _n(*shape):
    return _RNG.normal(0.0, 1.0, shape).astype(np.float32)


def _u(lo, hi, *shape):
    return _RNG.uniform(lo, hi, shape).astype(np.float32)


def _i(lo, hi, *shape, dtype=np.int32):
    return _RNG.randint(lo, hi, shape).astype(dtype)


def _image(*shape):
    return _RNG.randint(0, 256, shape).astype(np.uint8)


def _well_conditioned(n):
    return _n(n, n) + n * np.eye(n, dtype=np.float32)


_HIST = np.histogram(np.abs(_n(4000)), bins=601)

#: case id -> (op name, arrays, attrs)
CASES = {
    "arctan2": ("_npi_arctan2", [_n(3, 4), _n(3, 4)], {}),
    "arctan2-int": ("_npi_arctan2", [_i(-5, 5, 3, 4), _i(1, 5, 4)], {}),
    "arctan2_scalar": ("_npi_arctan2_scalar", [_n(3, 4)],
                       dict(scalar=0.5)),
    "arctan2_scalar-int": ("_npi_arctan2_scalar", [_i(-5, 5, 6)],
                           dict(scalar=2.0)),
    "rarctan2_scalar": ("_npi_rarctan2_scalar", [_n(3, 4)],
                        dict(scalar=-1.5)),
    "copysign": ("_npi_copysign", [_n(3, 4), _n(4)], {}),
    "copysign_scalar": ("_npi_copysign_scalar", [_n(3, 4)],
                        dict(scalar=-1.0)),
    "rcopysign_scalar": ("_npi_rcopysign_scalar", [_n(3, 4)],
                         dict(scalar=2.5)),
    "ldexp-int-exp": ("_npi_ldexp", [_n(3, 4), _i(-3, 4, 3, 4)], {}),
    "ldexp-float": ("_npi_ldexp", [_n(3, 4), _u(-2, 2, 3, 4)], {}),
    "ldexp_scalar": ("_npi_ldexp_scalar", [_n(3, 4)], dict(scalar=3)),
    "ldexp_scalar-int": ("_npi_ldexp_scalar", [_i(-4, 4, 5)],
                         dict(scalar=2)),
    "rldexp_scalar": ("_npi_rldexp_scalar", [_u(-2, 2, 3, 4)],
                      dict(scalar=1.5)),
    "bitwise_not": ("_npi_bitwise_not", [_i(-50, 50, 3, 4)], {}),
    "bitwise_not-bool": ("_npi_bitwise_not",
                         [np.array([True, False, True])], {}),
    "concatenate": ("_npi_concatenate", [_n(2, 3), _n(2, 1), _n(2, 2)],
                    dict(axis=1)),
    "concatenate-flat": ("_npi_concatenate", [_n(2, 3), _n(4)],
                         dict(axis=None)),
    "concatenate-mixed": ("_npi_concatenate", [_i(0, 5, 2), _n(3)], {}),
    "around-halves": ("_npi_around",
                      [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.7],
                                np.float32)], {}),
    "around-2": ("_npi_around", [_n(3, 4) * 10], dict(decimals=2)),
    "around-neg": ("_npi_around", [_n(3, 4) * 100], dict(decimals=-1)),
    "around-int": ("_npi_around", [_i(-50, 50, 5)], {}),
    "average": ("_npi_average", [_n(3, 4)], {}),
    "average-axis-weights": ("_npi_average", [_n(3, 4)],
                             dict(axis=1, weights=_u(0.5, 2, 4))),
    "average-returned": ("_npi_average", [_n(3, 4)],
                         dict(axis=0, weights=_u(0.5, 2, 3, 4),
                              returned=True)),
    "average-returned-count": ("_npi_average", [_n(3, 4)],
                               dict(axis=1, returned=True)),
    "average-int": ("_npi_average", [_i(0, 9, 3, 4)], {}),
    "bitwise_or": ("_npi_bitwise_or", [_i(0, 64, 3, 4), _i(0, 64, 4)], {}),
    "bitwise_or_scalar": ("_npi_bitwise_or_scalar", [_i(0, 64, 5)],
                          dict(scalar=5)),
    "bitwise_xor": ("_npi_bitwise_xor", [_i(0, 64, 3, 4), _i(0, 64, 3, 4)],
                    {}),
    "bitwise_xor_scalar": ("_npi_bitwise_xor_scalar", [_i(0, 64, 5)],
                           dict(scalar=9)),
    "lcm": ("_npi_lcm", [_i(-12, 13, 3, 4), _i(1, 13, 3, 4)], {}),
    "lcm_scalar": ("_npi_lcm_scalar", [_i(1, 20, 6)], dict(scalar=6)),
    "deg2rad": ("_npi_deg2rad", [_n(3, 4) * 90], {}),
    "deg2rad-int": ("_npi_deg2rad", [_i(-180, 180, 5)], {}),
    "rad2deg": ("_npi_rad2deg", [_n(3, 4)], {}),
    "nan_to_num": ("_npi_nan_to_num",
                   [np.array([np.nan, np.inf, -np.inf, 1.5], np.float32)],
                   {}),
    "nan_to_num-attrs": ("_npi_nan_to_num",
                         [np.array([np.nan, np.inf, -np.inf, -2.0],
                                   np.float32)],
                         dict(nan=-1.0, posinf=9.0, neginf=-9.0)),
    "diff": ("_npi_diff", [_n(4, 5)], {}),
    "diff-n2-axis0": ("_npi_diff", [_n(5, 3)], dict(n=2, axis=0)),
    "rot90": ("_npi_rot90", [_n(3, 4)], {}),
    "rot90-k-axes": ("_npi_rot90", [_n(2, 3, 4)], dict(k=-1, axes=(1, 2))),
    "roll": ("_np_roll", [_n(3, 4)], dict(shift=2, axis=1)),
    "roll-tuple": ("_np_roll", [_n(3, 4)], dict(shift=(1, -2),
                                                axis=(0, 1))),
    "roll-flat": ("_np_roll", [_n(3, 4)], dict(shift=5)),
    "moveaxis": ("_np_moveaxis", [_n(2, 3, 4)], dict(source=0,
                                                     destination=2)),
    "trace": ("_np_trace", [_n(4, 5)], dict(offset=1)),
    "trace-int-axes": ("_np_trace", [_i(0, 9, 2, 3, 3)],
                       dict(axis1=1, axis2=2)),
    "diagonal": ("_np_diagonal", [_n(2, 4, 3)], dict(offset=-1, axis1=1,
                                                     axis2=2)),
    "diagflat": ("_np_diagflat", [_n(2, 2)], dict(k=1)),
    "std": ("_npi_std", [_n(3, 4)], {}),
    "std-ddof-axis": ("_npi_std", [_n(3, 4)], dict(axis=1, ddof=1,
                                                   keepdims=True)),
    "std-int": ("_npi_std", [_i(0, 9, 3, 4)], dict(axis=0)),
    "var": ("_npi_var", [_n(3, 4)], dict(axis=(0, 1))),
    "var-ddof": ("_npi_var", [_n(5, 4)], dict(axis=0, ddof=1)),
    "full_like": ("_npi_full_like", [_n(2, 3)], dict(fill_value=2.5)),
    "full_like-dtype": ("_npi_full_like", [_n(2, 3)],
                        dict(fill_value=7, dtype="int32")),
    "logspace": ("_npi_logspace", [], dict(start=0.0, stop=2.0, num=5)),
    "logspace-open-base": ("_npi_logspace", [],
                           dict(start=1.0, stop=4.0, num=6, endpoint=False,
                                base=2.0, dtype="float32")),
    "indices": ("_npi_indices", [], dict(dimensions=(2, 3))),
    "indices-dtype": ("_npi_indices", [], dict(dimensions=(3, 1, 2),
                                               dtype="int64")),
    "hanning": ("_npi_hanning", [], dict(M=8)),
    "hanning-1": ("_npi_hanning", [], dict(M=1)),
    "hanning-0": ("_npi_hanning", [], dict(M=0)),
    "hamming": ("_npi_hamming", [], dict(M=7)),
    "hamming-1": ("_npi_hamming", [], dict(M=1)),
    "blackman": ("_npi_blackman", [], dict(M=9)),
    "blackman-1": ("_npi_blackman", [], dict(M=1)),
    "column_stack": ("_npi_column_stack", [_n(3), _n(3, 2)], {}),
    "vstack": ("_npi_vstack", [_n(3), _n(2, 3)], {}),
    "dstack": ("_npi_dstack", [_n(3), _n(1, 3)], {}),
    "solve-vector": ("_npi_solve", [_well_conditioned(4), _n(4)], {}),
    "solve-matrix": ("_npi_solve", [_well_conditioned(3), _n(3, 2)], {}),
    "tensorinv": ("_npi_tensorinv",
                  [(np.eye(6, dtype=np.float32) * 3 + _n(6, 6) * 0.3
                    ).reshape(2, 3, 6)], dict(ind=2)),
    "tensorsolve": ("_npi_tensorsolve",
                    [(np.eye(6, dtype=np.float32) * 3 + _n(6, 6) * 0.3
                      ).reshape(2, 3, 6), _n(2, 3)], {}),
    "bincount": ("_npi_bincount", [np.array([0, 2, 2, 5], np.int32)],
                 dict(minlength=8)),
    "bincount-weights": ("_npi_bincount",
                         [np.array([1, 1, 3, 0], np.float32)],
                         dict(weights=np.array([0.5, 1.5, 2.0, 4.0],
                                               np.float32))),
    "delete": ("_npi_delete", [_n(6)], dict(obj=1)),
    "delete-list-axis": ("_npi_delete", [_n(3, 5)], dict(obj=[0, 3],
                                                         axis=1)),
    "delete-slice": ("_npi_delete", [_n(4, 7)], dict(start=1, stop=6,
                                                     step=2, axis=1)),
    "delete-flat-negative": ("_npi_delete", [_n(2, 3)], dict(obj=-2)),
    "mask_assign_scalar": ("_npi_boolean_mask_assign_scalar",
                           [_n(3, 4), _i(0, 2, 3, 4).astype(np.float32)],
                           dict(value=9.0)),
    "mask_assign_scalar-int": ("_npi_boolean_mask_assign_scalar",
                               [_i(0, 9, 5), np.array([1, 0, 1, 0, 0],
                                                      np.int32)],
                               dict(value=2.5)),
    "mask_assign_tensor": ("_npi_boolean_mask_assign_tensor",
                           [_n(3, 4), np.array([True, False, True]
                                               )[:, None].repeat(4, 1),
                            _n(4)], {}),
    "share_memory": ("_npi_share_memory", [_n(3), _n(3)], {}),
    "to_tensor-hwc": ("_image_to_tensor", [_image(5, 4, 3)], {}),
    "to_tensor-nhwc": ("_image_to_tensor", [_image(2, 5, 4, 3)], {}),
    "to_tensor-float": ("_image_to_tensor", [_u(0, 255, 4, 4, 3)], {}),
    "normalize-chw": ("_image_normalize", [_u(0, 1, 3, 4, 5)],
                      dict(mean=(0.485, 0.456, 0.406),
                           std=(0.229, 0.224, 0.225))),
    "normalize-nchw": ("_image_normalize", [_u(0, 1, 2, 3, 4, 4)],
                       dict(mean=(0.5, 0.4, 0.3), std=(0.2, 0.3, 0.25))),
    "resize-down-uint8": ("_image_resize", [_image(2, 37, 29, 3)],
                          dict(size=(16, 20))),
    "resize-up-uint8": ("_image_resize", [_image(9, 7, 3)],
                        dict(size=20)),
    "resize-down-float": ("_image_resize", [_u(0, 1, 2, 30, 33, 3)],
                          dict(size=(11, 8))),
    "resize-nearest": ("_image_resize", [_image(2, 8, 6, 3)],
                       dict(size=(9, 12), interp=0)),
    "crop-x0y0": ("_image_crop", [_image(2, 9, 8, 3)],
                  dict(x0=2, y0=3, width=4, height=5)),
    "crop-x_y": ("_image_crop", [_image(9, 8, 3)],
                 dict(x_=1, y=2, width=6, height=3)),
    "cast_storage": ("cast_storage", [_n(3, 4)], dict(stype="default")),
    "cast_storage-csr-raises": ("cast_storage", [_n(3, 4)],
                                dict(stype="csr")),
    "square_sum": ("_square_sum", [_n(3, 4)], dict(axis=1, keepdims=True)),
    "square_sum-all-int": ("_square_sum", [_i(-5, 5, 3, 4)], {}),
    "calibrate_entropy": ("_contrib_calibrate_entropy",
                          [_HIST[0].astype(np.float32),
                           _HIST[1].astype(np.float32)],
                          dict(num_quantized_bins=255)),
}


def _floating(a):
    dt = np.asarray(a).dtype
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"


def _cotangents(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, np.shape(o)).astype(np.asarray(o).dtype)
            if _floating(o) else None for o in outs]


def _reference_job(op, arrays, attrs, seed):
    """The JAX op's case as a function of its floating inputs returning
    (outputs, gradients of the projection), or its eager result for a
    ``no_trace`` op; an exception where the reference refuses it."""
    fn = op.fn
    if op.no_trace:
        out = fn(*[jnp.asarray(a) for a in arrays], **attrs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return [np.asarray(o) for o in outs], None
    wrt = [i for i, a in enumerate(arrays) if _floating(a)] \
        if op.differentiable else []

    def run(*xs):
        full = [jnp.asarray(a) for a in arrays]
        for i, x in zip(wrt, xs):
            full[i] = x
        out = fn(*full, **attrs)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    xs = [arrays[i] for i in wrt]
    shapes = jax.eval_shape(run, *xs)
    if not any(_floating(np.zeros((), o.dtype)) for o in shapes):
        wrt = []
    if not wrt:
        return lambda: (run(), None), []
    cots = _cotangents([np.zeros(o.shape, o.dtype) for o in shapes], seed)

    def proj(*ys):
        outs = run(*ys)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)
                   if c is not None), outs

    grad = jax.value_and_grad(proj, argnums=tuple(range(len(wrt))),
                              has_aux=True)

    def job(*ys):
        (_, outs), grads = grad(*ys)
        full = [None] * len(arrays)
        for i, g in zip(wrt, grads):
            full[i] = g
        return outs, full

    return job, xs


_REFERENCE = {}


def _reference(case):
    """The reference's (outputs, gradients) of ``case`` or the exception
    it raised; the traceable cases run in one ``jax.jit``."""
    if not _REFERENCE:
        jobs = {}
        for c, (name, arrays, attrs) in CASES.items():
            try:
                got = _reference_job(jreg.OPS[name], arrays, attrs,
                                     sum(map(ord, c)))
            except Exception as exc:  # noqa: BLE001  (the reference refuses)
                _REFERENCE[c] = exc
                continue
            if callable(got[0]):
                jobs[c] = got
            else:
                _REFERENCE[c] = got
        run_all = jax.jit(lambda inputs: {c: jobs[c][0](*inputs[c])
                                          for c in jobs})
        done = run_all({c: jobs[c][1] for c in jobs})
        for c, (outs, grads) in done.items():
            _REFERENCE[c] = ([np.asarray(o) for o in outs],
                             None if grads is None else
                             [None if g is None else np.asarray(g)
                              for g in grads])
    return _REFERENCE[case]


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _port(op, arrays, attrs, seed):
    ts = [torch.tensor(np.asarray(a), requires_grad=_floating(a)
                       and op.differentiable) for a in arrays]
    if not arrays:
        attrs = dict(attrs, ctx="cpu")  # the port builds on the card else
    out = op.fn(*ts, **attrs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    np_outs = [_numpy(o) for o in outs]
    if not any(t.requires_grad for t in ts) \
            or not any(o.requires_grad for o in outs):
        return np_outs, None
    cots = _cotangents(np_outs, seed)
    total = sum((o * torch.tensor(c.astype(np.float32)).to(o.dtype)).sum()
                for o, c in zip(outs, cots)
                if c is not None and o.requires_grad)
    live = [t for t in ts if t.requires_grad]
    grads = iter(torch.autograd.grad(total, live, allow_unused=True))
    full = []
    for t in ts:
        g = next(grads) if t.requires_grad else None
        full.append(None if not t.requires_grad else
                    np.zeros(tuple(t.shape), np.float32) if g is None
                    else g.numpy())
    return np_outs, full


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if not _floating(want):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    w = want.astype(np.float64)
    err = float(np.max(np.abs(got.astype(np.float64) - w))) if w.size \
        else 0.0
    limit = tol * max(1.0, float(np.max(np.abs(w))) if w.size else 0.0)
    assert err <= limit, "%s: max abs err %g over %g" % (what, err, limit)


#: uint8 outputs of an antialiased resize: the f32 filter sums may round
#: to either side of an integer before the truncating cast
_INT_SLACK = {"resize-down-uint8": 1, "resize-up-uint8": 1}


@pytest.mark.parametrize("case", sorted(CASES))
def test_body_matches_reference(case):
    name, arrays, attrs = CASES[case]
    top = treg.OPS[name]
    seed = sum(map(ord, case))
    ref = _reference(case)
    if isinstance(ref, Exception):
        with pytest.raises(type(ref)):
            _port(top, arrays, attrs, seed)
        return
    want, want_g = ref
    got, got_g = _port(top, arrays, attrs, seed)
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        slack = _INT_SLACK.get(case)
        if slack:
            assert g.dtype == w.dtype and g.shape == w.shape
            diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
            assert diff.max() <= slack, diff.max()
            assert (diff > 0).mean() < 0.01, (diff > 0).mean()
            continue
        _close(g, w, "%s output %d" % (case, i))
    if want_g is not None:
        assert got_g is not None, "the port recorded no gradient"
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            if w is not None:
                _close(g, w, "%s gradient of input %d" % (case, i))


def test_svd_reconstructs_and_matches_magnitudes():
    a = _n(5, 3)
    want = [np.asarray(o) for o in jreg.OPS["_npi_svd"].fn(jnp.asarray(a))]
    got = [o.numpy() for o in treg.OPS["linalg_gesvd"].fn(torch.tensor(a))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose((got[0] * got[1]) @ got[2], a, atol=1e-5)
    np.testing.assert_allclose(np.abs(got[0]), np.abs(want[0]), atol=1e-5)
    np.testing.assert_allclose(np.abs(got[2]), np.abs(want[2]), atol=1e-5)


def test_host_ops_refuse_shape_inference():
    for name in ("_npi_tensorinv", "_npi_svd", "_npi_bincount",
                 "_npi_delete", "_npi_tensorsolve"):
        op = treg.OPS[name]
        metas = [torch.empty(2, 2, device="meta")] * (op.num_inputs or 1)
        with pytest.raises(TypeError, match="data-dependent"):
            op.infer(metas)


def test_share_memory_sees_views():
    """The reference's arrays never alias, so it answers False; the
    port's views share their storage."""
    a = torch.arange(6.0)
    op = treg.OPS["_npi_share_memory"]
    assert bool(op.fn(a, a[2:])) and not bool(op.fn(a, a.clone()))
    assert not bool(np.asarray(jreg.OPS["_npi_share_memory"].fn(
        jnp.asarray(a.numpy()), jnp.asarray(a.numpy()))))


def _groups(n, mp, rng):
    shapes = [(4, 3), (5,), (2, 2, 3)][:n]
    arrays = []
    for s in shapes:
        w32 = rng.normal(size=s).astype(np.float32)
        w = w32.astype(ml_dtypes.bfloat16) if mp else w32
        g = rng.normal(size=s).astype(np.float32) * 3
        m = rng.normal(size=s).astype(np.float32) * 0.1
        v = rng.uniform(0.1, 1.0, size=s).astype(np.float32)
        arrays += [w, g.astype(w.dtype), m, v] + ([w32] if mp else [])
    return arrays


@pytest.mark.parametrize("mp,clip", [(False, -1.0), (False, 1.5),
                                     (True, -1.0), (True, 1.5)])
def test_multi_adamw_matches_reference(mp, clip):
    name = "_multi_mp_adamw_update" if mp else "_multi_adamw_update"
    arrays = _groups(3, mp, np.random.RandomState(7))
    attrs = dict(num_weights=3, lrs=(0.01, 0.02, 0.005), wds=(0.1, 0.0, 0.3),
                 etas=(1.0, 0.5, 2.0), beta1=0.8, beta2=0.99, epsilon=1e-6,
                 rescale_grad=0.5, clip_gradient=clip)
    want = jreg.OPS[name].fn(*[jnp.asarray(a) for a in arrays], **attrs)
    got = treg.OPS[name].fn(*[torch.tensor(a.astype(np.float32)).to(
        torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 else torch.tensor(a)
        for a in arrays], **attrs)
    assert len(got) == len(want) == 3 * (4 if mp else 3)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = _numpy(g)
        assert str(g.dtype) == str(w.dtype), (i, g.dtype, w.dtype)
        if w.dtype == ml_dtypes.bfloat16:  # one rounding of the master
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), rtol=2 ** -8)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


# -- the samplers: shape, dtype and moments ----------------------------------

#: case id -> (op, arrays, attrs, mean, variance) of the draws: the
#: samplers of ``tools/np_surface_cases.py`` (the chip script draws them
#: on the card)
SAMPLER_CASES = {"%s-%d" % (row[0], i): row
                 for i, row in enumerate(SAMPLER_ROWS)}


def _reference_draw(name, arrays, attrs):
    out = jreg.OPS[name].fn(*[jnp.asarray(a) for a in arrays],
                            key=jax.random.PRNGKey(0), **attrs)
    return out if isinstance(out, tuple) else (out,)


def _port_draw(name, arrays, attrs):
    trandom.seed(24)
    if not arrays:
        attrs = dict(attrs, ctx="cpu")
    out = treg.OPS[name].fn(*[torch.tensor(a) for a in arrays], **attrs)
    return out if isinstance(out, tuple) else (out,)


def _moments_hold(x, mean, var, axis=-1):
    x = np.asarray(x, np.float64)
    m = x.mean(axis=axis)
    v = x.var(axis=axis)
    n = x.shape[axis]
    # the mean's standard error, and the variance's (4th moment bounded
    # by a few times var^2 for these distributions)
    assert np.all(np.abs(m - mean) <= 6 * np.sqrt(np.asarray(var) / n)), \
        (m, mean)
    assert np.all(np.abs(v - var) <= 6 * np.sqrt(8 * np.square(var) / n)), \
        (v, var)


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_shape_dtype_moments(case):
    name, arrays, attrs, mean, var = SAMPLER_CASES[case]
    want = _reference_draw(name, arrays, attrs)
    got = _port_draw(name, arrays, attrs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(_numpy(g).dtype) == str(np.asarray(w).dtype)
    _moments_hold(got[0].numpy(), mean, var)


def test_multinomial_draws_and_log_prob():
    """Rows of probabilities, one draw each with its log-probability
    (the reference's ``get_prob`` takes no ``shape``: ROADMAP, Noted in
    the reference), then many draws of each row by ``shape``."""
    p = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    rows = np.repeat(p, N // 2, axis=0)
    want = _reference_draw("_sample_multinomial", [rows],
                           dict(get_prob=True))
    got = _port_draw("_sample_multinomial", [rows], dict(get_prob=True))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (N,)
        assert str(_numpy(g).dtype) == str(np.asarray(w).dtype)
    draws = got[0].numpy()
    np.testing.assert_allclose(
        got[1].numpy(), np.log(np.maximum(rows, 1e-38))[np.arange(N),
                                                         draws], rtol=1e-6)
    shaped = _port_draw("_sample_multinomial", [p], dict(shape=(N,)))[0]
    ref_shaped = _reference_draw("_sample_multinomial", [p],
                                 dict(shape=(N,)))[0]
    assert tuple(shaped.shape) == tuple(ref_shaped.shape) == (2, N)
    for row in range(2):
        for d in (draws.reshape(2, -1)[row], shaped.numpy()[row]):
            freq = np.bincount(d, minlength=3) / d.size
            assert np.all(np.abs(freq - p[row]) <= 6 * np.sqrt(
                p[row] * (1 - p[row]) / d.size) + 1e-12), freq
    one = _port_draw("_sample_multinomial", [p[0]], {})
    ref_one = _reference_draw("_sample_multinomial", [p[0]], {})
    assert tuple(one[0].shape) == tuple(ref_one[0].shape) == ()


def test_shuffle_permutes_rows_only():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = _port_draw("_shuffle", [x], {})[0].numpy()
    want = np.asarray(_reference_draw("_shuffle", [x], {})[0])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert sorted(map(tuple, got)) == sorted(map(tuple, x))
    np.testing.assert_array_equal(got[:, 1:] - got[:, :1],
                                  np.tile([1, 2, 3], (10, 1)))


def test_samplers_follow_the_seed():
    a = _port_draw("_random_gamma", [], dict(alpha=0.7, shape=(64,)))[0]
    b = _port_draw("_random_gamma", [], dict(alpha=0.7, shape=(64,)))[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,kwargs", [
    ("gamma", dict(alpha=2.0, beta=0.5, shape=(3, 2))),
    ("exponential", dict(scale=2.0, shape=(4,))),
    ("poisson", dict(lam=3.0, shape=(2, 2))),
    ("negative_binomial", dict(k=3, p=0.4, shape=(5,))),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5)),
    ("bernoulli", dict(prob=0.3, shape=(6,)))])
def test_nd_random_samplers_match_reference(name, kwargs):
    """``mx.nd.random``'s samplers: the reference's shapes and dtypes."""
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as tmx

    want = getattr(jmx.nd.random, name)(**kwargs)
    got = getattr(tmx.nd.random, name)(ctx="cpu", **kwargs)
    assert got.shape == want.shape
    assert str(got.asnumpy().dtype) == str(want.asnumpy().dtype)


def test_nd_random_multinomial_and_shuffle():
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as tmx

    p = np.array([[0.2, 0.8], [0.5, 0.5]], np.float32)
    want = jmx.nd.random.multinomial(jmx.nd.array(p), shape=(3,))
    got = tmx.nd.random.multinomial(tmx.nd.array(p, ctx="cpu"), shape=(3,))
    assert got.shape == want.shape == (2, 3)
    assert str(got.asnumpy().dtype) == str(want.asnumpy().dtype)
    rows = np.arange(12, dtype=np.float32).reshape(6, 2)
    out = tmx.nd.random.shuffle(tmx.nd.array(rows, ctx="cpu")).asnumpy()
    assert sorted(map(tuple, out)) == sorted(map(tuple, rows))

