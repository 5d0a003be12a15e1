"""The port's op tail against the JAX package's, on the CPU: the 47 ops of
the reference's ``ops/tensor.py``, ``ops/nn.py`` and ``ops/math.py`` that
came over last, and the 1-D and 3-D forms of ``Pooling``.

Each case feeds the same numpy arrays to both registries: the op sweep's
case (``tools/op_sweep.py``'s ``build_cases()``) and the attribute cases
below (modes, ``output_mean_var``, ``adj``, lengths, ``blank_label``,
groups).  The forward is held, and for a differentiable op the gradient
of a fixed random projection of its floating outputs with respect to its
floating inputs, within 1e-5 of the output's (gradient's) largest
magnitude, at least 1e-5 absolute.  Integer outputs are equal.  Where the
reference raises, the port raises.

The reference side of every case runs in one ``jax.jit`` of all their
values and gradients, compiled once (eager JAX calls of these ops take
seconds); an op the reference marks ``no_trace`` runs eagerly on both
sides.
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
from incubator_mxnet_tpu_torch.ops import registry as treg

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0] + "/tools")
from op_sweep import build_cases  # noqa: E402

TOL = 1e-5

#: the ops of this slice (the reference's names)
TAIL = (
    "depth_to_space", "space_to_depth", "slice_like", "broadcast_axis",
    "split_v2", "batch_take", "gather_nd", "scatter_nd", "_scatter_set_nd",
    "Cast", "amp_cast", "amp_multicast", "_linspace", "_eye", "shape_array",
    "size_array", "SequenceMask", "SequenceLast", "SequenceReverse",
    "_np_nonzero", "_np_unique", "tril", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput",
    "Deconvolution", "batch_norm_stats", "LayerNorm", "GroupNorm",
    "InstanceNorm", "L2Normalization", "LRN", "LeakyReLU",
    "SoftmaxActivation", "UpSampling", "_contrib_BilinearResize2D",
    "_contrib_AdaptiveAvgPooling2D", "CTCLoss",
    "_scatter_elemwise_div", "make_loss", "smooth_l1", "gelu", "add_n",
    "khatri_rao", "softmin", "cumsum", "diag")

_SWEEP, _ = build_cases()
_RNG = np.random.RandomState(23)


def _n(*shape):
    return _RNG.normal(0.0, 1.0, shape).astype(np.float32)


def _u(lo, hi, *shape):
    return _RNG.uniform(lo, hi, shape).astype(np.float32)


def _labels():
    # 2 sequences of at most 3 labels in 1..5, right-padded with 0
    return np.array([[1, 3, 3], [2, 5, 0]], np.int32)


#: case id -> (op name, arrays, attrs)
CASES = {"sweep-" + name: (name,) + tuple(_SWEEP[name]) for name in TAIL}
CASES.update({
    "split_v2-sections": ("split_v2", [_n(2, 6, 3)],
                          dict(sections=3, axis=1, squeeze_axis=False)),
    "split_v2-squeeze": ("split_v2", [_n(4, 3)],
                         dict(sections=4, axis=0, squeeze_axis=True)),
    "Cast-int32": ("Cast", [_n(3, 4) * 3], dict(dtype="int32")),
    "amp_cast-bf16": ("amp_cast", [_n(3, 4)], dict(dtype="bfloat16")),
    "amp_cast-int": ("amp_cast", [np.arange(6, dtype=np.int32)],
                     dict(dtype="float16")),
    "amp_multicast-widest": ("amp_multicast",
                             [_n(2, 3), _n(2, 3).astype(np.float16)],
                             dict(num_outputs=2)),
    "amp_multicast-narrow": ("amp_multicast",
                             [_n(2, 3), _n(2, 3).astype(np.float16)],
                             dict(num_outputs=2, cast_narrow=True)),
    "_linspace-open": ("_linspace", [], dict(start=-1.5, stop=2.0, num=7,
                                             endpoint=False)),
    "_eye-rect-k": ("_eye", [], dict(N=3, M=5, k=1)),
    "SequenceMask-axis1": ("SequenceMask", [_n(2, 5, 3),
                                            np.array([2, 4], np.float32)],
                           dict(use_sequence_length=True, value=-1.0,
                                axis=1)),
    "SequenceLast-axis1": ("SequenceLast", [_n(2, 5, 3),
                                            np.array([5, 1], np.float32)],
                           dict(use_sequence_length=True, axis=1)),
    "SequenceReverse-all": ("SequenceReverse", [_n(4, 2, 3)], {}),
    "_np_nonzero-size": ("_np_nonzero",
                         [np.array([[0, 1, 0], [2, 0, 3]], np.float32)],
                         dict(size=4)),
    "_np_unique-all": ("_np_unique",
                       [np.array([3, 1, 3, 7, 1, 0], np.int32)],
                       dict(return_index=True, return_inverse=True,
                            return_counts=True)),
    "tril-k": ("tril", [_n(4, 5)], dict(k=-1)),
    "MAE-grad_scale": ("MAERegressionOutput", [_n(3, 4), _n(3, 4)],
                       dict(grad_scale=2.5)),
    "Logistic-label-shape": ("LogisticRegressionOutput", [_n(4, 1), _n(4)],
                             {}),
    "Deconvolution-stride-pad-adj": (
        "Deconvolution", [_n(2, 3, 5, 5), _n(3, 4, 3, 3), _n(4)],
        dict(kernel=(3, 3), num_filter=4, stride=(2, 2), pad=(1, 1),
             adj=(1, 1), no_bias=False)),
    "Deconvolution-dilate": (
        "Deconvolution", [_n(1, 2, 4, 4), _n(2, 3, 3, 3)],
        dict(kernel=(3, 3), num_filter=3, dilate=(2, 2), pad=(1, 1))),
    "Deconvolution-adj-stride1": (
        "Deconvolution", [_n(1, 2, 4, 4), _n(2, 3, 2, 2)],
        dict(kernel=(2, 2), num_filter=3, adj=(1, 1))),
    "Deconvolution-1d": ("Deconvolution", [_n(2, 3, 6), _n(3, 2, 4)],
                         dict(kernel=(4,), num_filter=2, stride=(2,),
                              pad=(1,))),
    "Deconvolution-3d": ("Deconvolution", [_n(1, 2, 3, 4, 3),
                                           _n(2, 2, 2, 3, 2)],
                         dict(kernel=(2, 3, 2), num_filter=2,
                              stride=(2, 1, 2))),
    "Deconvolution-groups": ("Deconvolution", [_n(2, 4, 5, 5),
                                               _n(4, 2, 3, 3)],
                             dict(kernel=(3, 3), num_filter=4, num_group=2,
                                  stride=(2, 2), pad=(1, 1))),
    "Deconvolution-groups-raises": ("Deconvolution", [_n(2, 4, 5, 5),
                                                      _n(4, 3, 3, 3)],
                                    dict(kernel=(3, 3), num_filter=6,
                                         num_group=2)),
    "batch_norm_stats-axis": ("batch_norm_stats", [_n(2, 3, 4, 5) + 2],
                              dict(axis=2)),
    "LayerNorm-mean_var-axis1": ("LayerNorm", [_n(2, 5, 3), _n(5), _n(5)],
                                 dict(axis=1, eps=1e-3,
                                      output_mean_var=True)),
    "GroupNorm-mean_var": ("GroupNorm", [_n(2, 6, 3, 4), _n(6), _n(6)],
                           dict(num_groups=3, output_mean_var=True)),
    "InstanceNorm-1d": ("InstanceNorm", [_n(2, 3, 7), _n(3), _n(3)],
                        dict(eps=1e-5)),
    "L2Normalization-channel": ("L2Normalization", [_n(2, 3, 4, 4)],
                                dict(mode="channel")),
    "L2Normalization-spatial": ("L2Normalization", [_n(2, 3, 4, 4)],
                                dict(mode="spatial")),
    "LRN-5": ("LRN", [_n(2, 7, 3, 3)], dict(nsize=5, alpha=1e-2,
                                            beta=0.5, knorm=1.5)),
    "LeakyReLU-slope": ("LeakyReLU", [_n(3, 4)], dict(slope=0.1)),
    "LeakyReLU-prelu": ("LeakyReLU", [_n(2, 3, 4, 4), _u(0.1, 0.5, 3)],
                        dict(act_type="prelu")),
    "LeakyReLU-elu": ("LeakyReLU", [_n(3, 4)], dict(act_type="elu",
                                                   slope=0.7)),
    "LeakyReLU-selu": ("LeakyReLU", [_n(3, 4)], dict(act_type="selu")),
    "LeakyReLU-gelu": ("LeakyReLU", [_n(3, 4)], dict(act_type="gelu")),
    "LeakyReLU-rrelu-eval": ("LeakyReLU", [_n(3, 4)],
                             dict(act_type="rrelu")),
    "SoftmaxActivation-channel": ("SoftmaxActivation", [_n(2, 4, 3)],
                                  dict(mode="channel")),
    "UpSampling-bilinear": ("UpSampling", [_n(1, 2, 5, 4), _n(2, 1, 4, 4)],
                            dict(scale=2, sample_type="bilinear",
                                 num_filter=2)),
    "UpSampling-nearest-concat": ("UpSampling", [_n(1, 2, 3, 3),
                                                 _n(1, 3, 3, 3)],
                                  dict(scale=2, num_args=2)),
    "UpSampling-nearest-sum": ("UpSampling", [_n(1, 2, 3, 3),
                                              _n(1, 2, 3, 3)],
                               dict(scale=3, num_args=2,
                                    multi_input_mode="sum")),
    "BilinearResize2D-down": ("_contrib_BilinearResize2D", [_n(1, 2, 9, 8)],
                              dict(height=4, width=3)),
    "BilinearResize2D-scale": ("_contrib_BilinearResize2D",
                               [_n(2, 1, 4, 6)],
                               dict(scale_height=1.5, scale_width=0.5,
                                    align_corners=False, mode="like")),
    "AdaptiveAvgPooling2D-blocks": ("_contrib_AdaptiveAvgPooling2D",
                                    [_n(1, 2, 8, 6)],
                                    dict(output_size=(2, 3))),
    "AdaptiveAvgPooling2D-raises": ("_contrib_AdaptiveAvgPooling2D",
                                    [_n(1, 2, 7, 7)],
                                    dict(output_size=(3, 3))),
    "CTCLoss-lengths": ("CTCLoss", [_n(6, 2, 6), _labels().astype(
        np.float32), np.array([6, 4], np.float32),
        np.array([3, 1], np.float32)],
        dict(use_data_lengths=True, use_label_lengths=True)),
    "CTCLoss-blank-last": ("CTCLoss", [_n(5, 2, 6), np.array(
        [[0, 2, 2], [4, -1, -1]], np.float32)], dict(blank_label="last")),
    "CTCLoss-impossible": ("CTCLoss", [_n(2, 2, 4), np.array(
        [[1, 2, 3], [1, 1, 0]], np.int32)], {}),
    "make_loss-attrs": ("make_loss", [_n(3, 4)], dict(grad_scale=3.0,
                                                      normalization="batch")),
    "smooth_l1-scalar": ("smooth_l1", [_n(3, 4)], dict(scalar=2.0)),
    "gelu-tanh": ("gelu", [_n(3, 4)], dict(approximate=True)),
    "add_n-3": ("add_n", [_n(2, 3), _n(2, 3), _n(2, 3)], {}),
    "khatri_rao-3": ("khatri_rao", [_n(2, 3), _n(3, 3), _n(2, 3)], {}),
    "softmin-temperature": ("softmin", [_n(3, 5)], dict(axis=0,
                                                        temperature=2.0)),
    "cumsum-axis-dtype": ("cumsum", [_n(3, 4)], dict(axis=1,
                                                     dtype="float64")),
    "cumsum-int": ("cumsum", [np.arange(12, dtype=np.int32).reshape(3, 4)],
                   dict(axis=0)),
    "diag-1d-k": ("diag", [_n(3)], dict(k=1)),
    "diag-3d-axes": ("diag", [_n(3, 4, 5)], dict(k=-1, axis1=1, axis2=2)),
    # Pooling over 1 and 3 spatial axes
    "Pooling-1d-max-full": ("Pooling", [_n(2, 3, 9)],
                            dict(kernel=(3,), stride=(2,), pad=(1,),
                                 pool_type="max",
                                 pooling_convention="full")),
    "Pooling-1d-avg-nopad": ("Pooling", [_n(2, 3, 9)],
                             dict(kernel=(3,), stride=(2,), pad=(1,),
                                  pool_type="avg",
                                  count_include_pad=False)),
    "Pooling-1d-lp": ("Pooling", [_n(2, 3, 8)],
                      dict(kernel=(2,), stride=(2,), pool_type="lp",
                           p_value=3)),
    "Pooling-3d-max": ("Pooling", [_n(1, 2, 5, 6, 5)],
                       dict(kernel=(2, 3, 2), stride=(2, 2, 1),
                            pad=(1, 1, 0), pool_type="max")),
    "Pooling-3d-avg-full": ("Pooling", [_n(1, 2, 5, 6, 5)],
                            dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                 pool_type="avg",
                                 pooling_convention="full")),
    "Pooling-3d-sum": ("Pooling", [_n(1, 2, 4, 4, 4)],
                       dict(kernel=(2, 2, 2), stride=(1, 2, 2),
                            pool_type="sum")),
    "Pooling-1d-global-lp": ("Pooling", [_n(2, 3, 7)],
                             dict(kernel=(1,), global_pool=True,
                                  pool_type="lp")),
})


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
    ``no_trace`` op; an exception where the reference refuses the case
    (found by abstract evaluation, without compiling)."""
    fn = op.fn
    attrs = dict(attrs)
    if op.needs_rng:
        attrs["key"] = jax.random.PRNGKey(0)
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
        wrt = []  # integer outputs only: nothing to differentiate
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
    """The reference's (outputs, gradients) of ``case`` (or the exception
    it raised).  Every traceable case runs in one ``jax.jit`` of them
    all, compiled once for the module."""
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


def _to_torch(a):
    a = np.asarray(a)
    return torch.tensor(a, requires_grad=_floating(a))


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _port(op, arrays, attrs, seed):
    ts = [_to_torch(a) for a in arrays]
    if not arrays:
        attrs = dict(attrs, ctx="cpu")  # the port builds on the card else
    out = op.fn(*ts, **attrs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    np_outs = [_numpy(o) for o in outs]
    if not op.differentiable or not any(t.requires_grad for t in ts) \
            or not any(o.requires_grad for o in outs):
        return np_outs, None
    cots = _cotangents(np_outs, seed)
    total = sum((o * torch.tensor(c.astype(np.float32)).to(o.dtype)).sum()
                for o, c in zip(outs, cots)
                if c is not None and o.requires_grad)
    live = [t for t in ts if t.requires_grad]
    grads = torch.autograd.grad(total, live, allow_unused=True)
    full, it = [], iter(grads)
    for t in ts:
        g = next(it) if t.requires_grad else None
        full.append(None if g is None and not t.requires_grad
                    else (np.zeros(tuple(t.shape), np.float32) if g is None
                          else g.numpy()))
    return np_outs, full


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not _floating(want):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    w = want.astype(np.float64)
    err = float(np.max(np.abs(got.astype(np.float64) - w))) if w.size \
        else 0.0
    limit = TOL * max(1.0, float(np.max(np.abs(w))) if w.size else 0.0)
    assert err <= limit, "%s: max abs err %g over %g" % (what, err, limit)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, arrays, attrs = CASES[case]
    jop, top = jreg.OPS[name], treg.OPS[name]
    assert top.name == jop.name
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
        _close(g, w, "%s output %d" % (case, i))
    if want_g is not None:
        assert got_g is not None
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            if w is not None:
                _close(g, w, "%s gradient of input %d" % (case, i))


def _reference_names():
    """The names that the reference's ops/tensor.py, ops/nn.py and
    ops/math.py register, aliases included: the canonical name of each
    of their ops, the ``aliases=`` of their ``register`` calls and the
    alias tables of their registration loops (later modules add more
    aliases to these ops: those are another slice's)."""
    import ast
    import importlib
    import inspect

    names = set()
    for m in ("tensor", "nn", "math"):
        mod = importlib.import_module("incubator_mxnet_tpu.ops." + m)
        names |= {op.name for op in jreg.OPS.values()
                  if op.fn.__module__ == mod.__name__}
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, ast.keyword) and node.arg == "aliases" \
                    and isinstance(node.value, ast.Tuple):
                names |= {e.value for e in node.value.elts
                          if isinstance(e, ast.Constant)}
        for table in ("_BINARY_ALIASES", "_UNARY_ALIASES"):
            for aliases in getattr(mod, table, {}).values():
                names |= set(aliases)
        names |= {n.replace("broadcast_", "_")
                  for n in getattr(mod, "_CMP", {})}
    return names


def test_registry_has_every_reference_op():
    """Every name (with its aliases) that the reference's ops/tensor.py,
    ops/nn.py and ops/math.py register is in the port's registry, on the
    op of the same canonical name."""
    names = _reference_names()
    assert set(TAIL) <= names
    missing = sorted(n for n in names if n not in treg.OPS)
    assert not missing, missing
    for n in names:
        assert treg.OPS[n].name == jreg.OPS[n].name, n


def test_unique_refuses_shape_inference_and_nonzero_infers():
    """``_np_unique``'s shape depends on its data: it runs on arrays and
    refuses symbolic inference, as the reference's (``no_trace``);
    ``_np_nonzero`` pads to a known size, so its shape is inferred, as
    the reference's ``jax.eval_shape`` infers it."""
    meta = torch.empty((3, 4), device="meta")
    with pytest.raises(TypeError, match="data-dependent"):
        treg.OPS["_np_unique"].infer([meta])
    (out,) = treg.OPS["_np_nonzero"].infer([meta])
    (want,) = jreg.OPS["_np_nonzero"].infer(
        [jax.ShapeDtypeStruct((3, 4), np.float32)])
    assert tuple(out.shape) == tuple(want.shape)
    assert out.dtype == torch.int64 and want.dtype == np.int64


def test_rrelu_draws_in_training_from_the_port_generator():
    """rrelu's negative slopes are drawn in training from the port's
    generator (one draw an element in [lower, upper)); equal generators
    draw equal slopes, and outside training the slope is their mean."""
    from incubator_mxnet_tpu_torch.ops import nn as tnn

    x = -torch.ones(4, 5)
    a = tnn.leaky_relu(x, act_type="rrelu", training=True,
                       generator=torch.Generator().manual_seed(3))
    b = tnn.leaky_relu(x, act_type="rrelu", training=True,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    slopes = -a
    assert bool(((slopes >= 0.125) & (slopes < 0.334)).all())
    assert len(torch.unique(slopes)) > 1
    ev = tnn.leaky_relu(x, act_type="rrelu", training=False)
    assert torch.allclose(ev, -torch.full((4, 5), (0.125 + 0.334) / 2))
