"""The port's ``ops/parity_tail.py`` against the JAX package's, on the CPU,
and the registry guard: the port registers every name the reference
does, no more and no fewer, with the same output counts.

Every case of the reference's ``tests/test_parity_tail.py`` is a case
here (and more modes of the same ops), fed the same numpy arrays on
both sides (``torch_op_parity``): forward, and the gradient of a fixed
random projection where the op is differentiable.  Index, integer and
optimizer outputs are equal; float ops within 1e-5 of the output's
largest magnitude (at least 1e-5 absolute) in float32; the samplers by
their moments.  ``edge_id`` takes a CSR array and waits for the sparse
frontend.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import registry as treg

from torch_op_parity import check, reference

_RNG = np.random.RandomState(31)


def _n(*shape):
    return _RNG.normal(0.0, 1.0, shape).astype(np.float32)


def _u(lo, hi, *shape):
    return _RNG.uniform(lo, hi, shape).astype(np.float32)


def _f(*vals):
    return np.array(vals, np.float32)


def _hawkes():
    rng = np.random.RandomState(0)
    k, n, t = 3, 2, 8
    return [rng.uniform(0.1, 0.5, k).astype(np.float32),
            rng.uniform(0.1, 0.4, k).astype(np.float32),
            rng.uniform(0.5, 2.0, k).astype(np.float32),
            rng.exponential(0.5, (n, t)).astype(np.float32),
            rng.randint(0, k, (n, t)).astype(np.float32),
            _f(t, t - 3), None]


_HAWKES = _hawkes()
_HAWKES[6] = _HAWKES[3].sum(axis=1) + 1.0
_SPARSE = np.where(_RNG.rand(4, 5) < 0.5, 0.0, _n(4, 5)).astype(np.float32)
_ANCHORS = np.array([[[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.8]]],
                    np.float32)
_REFS = np.array([[[0.15, 0.1, 0.55, 0.56], [0.5, 0.4, 0.95, 0.9]]],
                 np.float32)
_W16 = _u(0, 1, 3).astype(np.float16)


#: case id -> (op name, arrays, attrs)
CASES = {
    # the comparison and scatter aliases
    "less": ("less", [_f(1, 2, 3), _f(2, 2, 2)], {}),
    "greater_equal": ("greater_equal", [_f(1, 2, 3), _f(2, 2, 2)], {}),
    "not_equal": ("not_equal", [_f(1, 2, 3), _f(2, 2, 2)], {}),
    "equal": ("equal", [_f(1, 2, 3), _f(2, 2, 2)], {}),
    "greater": ("greater", [_f(1, 2, 3), _f(2, 2, 2)], {}),
    "less_equal": ("less_equal", [_f(1, 2, 3), _f(2, 2, 2)], {}),
    "_scatter_plus_scalar": ("_scatter_plus_scalar", [_n(3, 4)],
                             dict(scalar=2.5)),
    "_scatter_minus_scalar": ("_scatter_minus_scalar", [_n(3, 4)],
                              dict(scalar=2.5)),
    "_grad_add": ("_grad_add", [_n(3, 4), _n(3, 4)], {}),
    "_hypot": ("_hypot", [_n(3, 4), _n(3, 4)], {}),
    "BatchNorm_v1": ("BatchNorm_v1", [_n(4, 3, 5, 5), _u(0.5, 1.5, 3),
                                      _n(3), _n(3), _u(0.5, 1.5, 3)],
                     dict(fix_gamma=False)),
    # scalar logic, hypot
    "_logical_and_scalar": ("_logical_and_scalar", [_f(0, 1, -2, 0)],
                            dict(scalar=2.0)),
    "_logical_and_scalar-0": ("_logical_and_scalar", [_f(0, 1, -2, 0)],
                              dict(scalar=0.0)),
    "_logical_or_scalar": ("_logical_or_scalar", [_f(0, 1, -2, 0)],
                           dict(scalar=0.0)),
    "_logical_xor_scalar": ("_logical_xor_scalar", [_f(0, 1, -2, 0)],
                            dict(scalar=1.0)),
    "_hypot_scalar": ("_hypot_scalar", [_n(3, 4)], dict(scalar=1.5)),
    # tensor utilities
    "moments-all": ("moments", [_u(0, 1, 3, 4)], dict(axes=(0, 1))),
    "moments-keepdims": ("moments", [_n(2, 3, 4) + 50.0],
                         dict(axes=(1,), keepdims=True)),
    "reshape_like": ("reshape_like", [_n(3, 4), np.zeros((4, 3),
                                                         np.float32)], {}),
    "reshape_like-ranges": ("reshape_like", [_n(2, 3, 4), _n(6, 5)],
                            dict(lhs_begin=0, lhs_end=2, rhs_begin=0,
                                 rhs_end=1)),
    "softmax_cross_entropy": ("softmax_cross_entropy",
                              [_u(0, 1, 5, 7),
                               _RNG.randint(0, 7, 5).astype(np.float32)],
                              {}),
    "_histogram": ("_histogram", [_n(50)], dict(bin_cnt=7)),
    "histogram-range": ("histogram", [_n(6, 8)],
                        dict(bin_cnt=5, range=(-1.0, 1.0))),
    "_ravel_multi_index": ("_ravel_multi_index",
                           [np.array([[0, 1, 2, 5], [3, 0, 4, 1]],
                                     np.int64)], dict(shape=(3, 4))),
    "_unravel_index": ("_unravel_index", [np.array([0, 7, 59, 22],
                                                   np.int64)],
                       dict(shape=(3, 4, 5))),
    "_slice_assign": ("_slice_assign", [np.zeros((3, 3), np.float32),
                                        np.ones((1, 3), np.float32)],
                      dict(begin=(1, 0), end=(2, 3))),
    "_slice_assign-step": ("_slice_assign", [_n(4, 6), _n(2, 3)],
                           dict(begin=(0, 5), end=(4, None), step=(2, -2))),
    "_slice_assign_scalar": ("_slice_assign_scalar",
                             [np.zeros((3, 3), np.float32)],
                             dict(scalar=7.0, begin=(0, 0), end=(1, 1))),
    "_split_v2-sections": ("_split_v2", [np.arange(10, dtype=np.float32)],
                           dict(sections=5)),
    "_split_v2-indices": ("_split_v2", [np.arange(10, dtype=np.float32)],
                          dict(indices=(3, 7))),
    "_identity_with_attr_like_rhs": ("_identity_with_attr_like_rhs",
                                     [_n(3, 4), _n(2)], {}),
    "_zeros_without_dtype": ("_zeros_without_dtype", [], dict(shape=(2, 3))),
    "_np_all": ("_np_all", [_f(1, 0, 2, 3).reshape(2, 2)], {}),
    "_np_all-axis": ("_np_all", [_f(1, 0, 2, 3).reshape(2, 2)],
                     dict(axis=1, keepdims=True)),
    "_np_any-axis": ("_np_any", [_f(0, 0, 2, 0).reshape(2, 2)],
                     dict(axis=0)),
    "all": ("all", [_n(3, 4)], dict(axis=(0, 1))),
    # im2col / col2im
    "im2col": ("im2col", [_u(0, 1, 2, 3, 6, 6)],
               dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "im2col-dilate": ("im2col", [_n(1, 2, 7, 6)],
                      dict(kernel=(2, 3), dilate=(2, 1), pad=(1, 0))),
    "im2col-1d": ("im2col", [_n(2, 3, 9)], dict(kernel=(3,), stride=(2,))),
    "im2col-3d": ("im2col", [_n(1, 2, 4, 5, 4)],
                  dict(kernel=(2, 2, 3), stride=(1, 2, 1), pad=(0, 1, 1))),
    "col2im": ("col2im", [_u(0, 1, 2, 27, 9)],
               dict(output_size=(6, 6), kernel=(3, 3), stride=(2, 2),
                    pad=(1, 1))),
    "col2im-dilate": ("col2im", [_n(1, 12, 28)],
                      dict(output_size=(7, 6), kernel=(2, 3), dilate=(2, 1),
                           pad=(1, 0))),
    # straight-through estimators
    "_contrib_round_ste": ("_contrib_round_ste", [_f(-1.4, 0.3, 2.6)], {}),
    "_contrib_sign_ste": ("_contrib_sign_ste", [_f(-1.4, 0.0, 2.6)], {}),
    "_contrib_gradientmultiplier": ("_contrib_gradientmultiplier",
                                    [_f(-1.4, 0.3, 2.6)], dict(scalar=0.5)),
    # contrib helpers
    "_contrib_quadratic": ("_contrib_quadratic", [_n(3, 4)],
                           dict(a=1.5, b=-2.0, c=0.25)),
    "_npx_quadratic": ("_npx_quadratic", [_n(5)], dict(a=2.0)),
    "_contrib_allclose": ("_contrib_allclose", [_f(1, 2), _f(1, 2.000001)],
                          {}),
    "_contrib_allclose-far": ("_contrib_allclose", [_f(1, 2), _f(1, 2.1)],
                              dict(rtol=1e-3)),
    "_contrib_arange_like": ("_contrib_arange_like",
                             [np.zeros((2, 3), np.float32)],
                             dict(start=1.0)),
    "_contrib_arange_like-axis": ("_contrib_arange_like",
                                  [np.zeros((2, 5), np.float32)],
                                  dict(start=-1.0, step=0.5, repeat=2,
                                       axis=1)),
    "_contrib_getnnz": ("_contrib_getnnz", [_f(1, 0, 0, 2).reshape(2, 2)],
                        {}),
    "_contrib_getnnz-axis": ("_contrib_getnnz", [_SPARSE], dict(axis=0)),
    "_contrib_box_encode": ("_contrib_box_encode",
                            [np.ones((1, 2), np.float32),
                             np.array([[0, 1]], np.float32), _ANCHORS,
                             _REFS], {}),
    "_contrib_box_encode-means": ("_contrib_box_encode",
                                  [_f(1, 0).reshape(1, 2),
                                   np.array([[1, 0]], np.float32), _ANCHORS,
                                   _REFS],
                                  dict(means=(0.1, 0.0, -0.1, 0.0),
                                       stds=(0.2, 0.2, 0.3, 0.3))),
    "_contrib_box_decode": ("_contrib_box_decode",
                            [_n(1, 2, 4) * 0.5, _ANCHORS], {}),
    "_contrib_box_decode-center": ("_contrib_box_decode",
                                   [_n(1, 2, 4) * 0.5,
                                    _u(0.2, 0.8, 1, 2, 4)],
                                   dict(format="center", clip=0.7)),
    # multi-tensor and mixed-precision updates
    "multi_sum_sq": ("multi_sum_sq", [_f(1, 2), _f(3, 4).reshape(2, 1)],
                     dict(num_arrays=2)),
    "multi_sum_sq-f16": ("multi_sum_sq", [_n(5, 3).astype(np.float16),
                                          _n(7)], dict(num_arrays=2)),
    "reset_arrays": ("reset_arrays", [_f(1, 2), _n(2, 1)],
                     dict(num_arrays=2)),
    "multi_lars": ("multi_lars", [_f(0.1, 0.1), _f(4.0, 0.0), _f(1.0, 1.0)],
                   dict(wds=(0.0, 0.0), eta=0.01)),
    "multi_lars-wd": ("multi_lars", [_u(0.05, 0.2, 6), _u(0, 4, 6),
                                     _u(0, 2, 6)],
                      dict(wds=(1e-4,) * 6, eta=0.001, rescale_grad=0.5)),
    "mp_nag_mom_update": ("mp_nag_mom_update",
                          [_W16, _n(3).astype(np.float16), _n(3),
                           _W16.astype(np.float32)],
                          dict(lr=0.1, momentum=0.9, wd=0.01)),
    "mp_lamb_update_phase1": ("mp_lamb_update_phase1",
                              [_W16, _n(3).astype(np.float16), _n(3) * 0.1,
                               _u(0, 1, 3), _W16.astype(np.float32)],
                              dict(t=3, wd=0.01, clip_gradient=0.5)),
    "mp_lamb_update_phase2": ("mp_lamb_update_phase2",
                              [_W16, _n(3), _f(2.0), _f(0.5),
                               _W16.astype(np.float32)],
                              dict(lr=0.1, lower_bound=0.5,
                                   upper_bound=3.0)),
    "_mp_adamw_update": ("_mp_adamw_update",
                         [_W16, _u(0, 1, 3).astype(np.float16),
                          np.zeros(3, np.float32), np.zeros(3, np.float32),
                          _W16.astype(np.float32)],
                         dict(lr=0.1, wd=0.01)),
    "preloaded_multi_sgd_update": ("preloaded_multi_sgd_update",
                                   [_u(0, 1, 4), _u(0, 1, 4),
                                    _u(0, 1, 2, 2), _u(0, 1, 2, 2),
                                    _f(0.1, 0.2), _f(0.0, 0.0)],
                                   dict(num_weights=2)),
    "preloaded_multi_sgd_update-wd": ("preloaded_multi_sgd_update",
                                      [_n(4), _n(4), _n(2, 2), _n(2, 2),
                                       _f(0.1, 0.2), _f(0.01, 0.001)],
                                      dict(num_weights=2, rescale_grad=0.5,
                                           clip_gradient=0.3)),
    "preloaded_multi_sgd_mom_update": ("preloaded_multi_sgd_mom_update",
                                       [_n(4), _n(4), _n(4), _n(2, 3),
                                        _n(2, 3), _n(2, 3), _f(0.1, 0.05),
                                        _f(1e-4, 0.0)],
                                       dict(num_weights=2, momentum=0.9)),
    "preloaded_multi_mp_sgd_update": ("preloaded_multi_mp_sgd_update",
                                      [_W16, _n(3).astype(np.float16),
                                       _W16.astype(np.float32), _f(0.1),
                                       _f(0.01)], dict(num_weights=1)),
    "preloaded_multi_mp_sgd_mom_update": (
        "preloaded_multi_mp_sgd_mom_update",
        [_W16, _n(3).astype(np.float16), _n(3), _W16.astype(np.float32),
         _n(2, 2).astype(np.float16), _n(2, 2).astype(np.float16),
         _n(2, 2), _n(2, 2), _f(0.1, 0.2), _f(0.01, 0.0)],
        dict(num_weights=2, momentum=0.9, rescale_grad=2.0)),
    "_contrib_group_adagrad_update": ("_contrib_group_adagrad_update",
                                      [_u(0, 1, 2, 3), _u(0, 1, 2, 3),
                                       np.zeros(2, np.float32)],
                                      dict(lr=0.1)),
    "_contrib_group_adagrad_update-clip": (
        "_contrib_group_adagrad_update", [_n(3, 2, 2), _n(3, 2, 2),
                                          _u(0, 1, 3)],
        dict(lr=0.05, rescale_grad=2.0, clip_gradient=0.5, epsilon=1e-3)),
    # the regulariser and the Hawkes process
    "IdentityAttachKLSparseReg": ("IdentityAttachKLSparseReg",
                                  [_u(0.05, 0.95, 6, 4)],
                                  dict(sparseness_target=0.2,
                                       penalty=0.05)),
    "_contrib_hawkesll": ("_contrib_hawkesll", _HAWKES, {}),
}

#: ops whose every output is held equal: index, integer and optimizer ops
EXACT = {"_ravel_multi_index", "_unravel_index", "_slice_assign",
         "_slice_assign_scalar", "_zeros_without_dtype", "_np_all", "all",
         "_np_any", "_contrib_arange_like", "_contrib_getnnz",
         "reset_arrays", "multi_lars", "mp_nag_mom_update",
         "mp_lamb_update_phase1", "mp_lamb_update_phase2",
         "_mp_adamw_update", "preloaded_multi_sgd_update",
         "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
         "preloaded_multi_mp_sgd_mom_update", "_contrib_group_adagrad_update",
         "_split_v2", "_identity_with_attr_like_rhs", "less",
         "greater_equal", "not_equal", "equal", "greater", "less_equal"}

_REF = {}


def _reference(case):
    if not _REF:
        _REF.update(reference(jreg.OPS, CASES))
    return _REF[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name = CASES[case][0]
    check(case, CASES, _reference(case), jreg.OPS, treg.OPS,
          exact=name in EXACT)


def test_registry_equals_reference():
    """The port's registry holds the reference's names, all 655 of them,
    no more and no fewer, each on the op of the same canonical name with
    the same output count (the count composition gives a node: the
    registered count, or the op's arity rule)."""
    from incubator_mxnet_tpu import symbol as jsym

    from incubator_mxnet_tpu_torch import symbol as tsym

    assert len(jreg.OPS) == 655
    assert sorted(treg.OPS) == sorted(jreg.OPS)
    for name, op in jreg.OPS.items():
        assert treg.OPS[name].name == op.name, name
        assert treg.OPS[name].num_outputs == op.num_outputs \
            or name in _ARITY_BY_RULE, name
        if name != "Custom":
            assert tsym._compose_num_outputs(name, {}) \
                == jsym._compose_num_outputs(name, {}), name
    for new in _NEW_NAMES:
        jop, top = jreg.OPS[new], treg.OPS[new]
        assert (top.differentiable, top.no_trace, tuple(top.mutate_idx)) \
            == (jop.differentiable, jop.no_trace,
                tuple(jop.mutate_idx or ())), new


#: names whose registered count differs and whose arity rule agrees (the
#: split family registers None in the reference, batch_norm_stats 1)
_ARITY_BY_RULE = {"SliceChannel", "split", "split_v2", "_split_v2",
                  "_npi_split", "batch_norm_stats"}


def _new_names():
    import ast
    import inspect

    from incubator_mxnet_tpu.ops import contrib_tail, parity_tail

    names = {"Custom", "_split_v2"}
    for mod in (parity_tail, contrib_tail):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in ("register", "_alias", "_like_sampler") \
                    and node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


_NEW_NAMES = _new_names()


def test_split_v2_composes_with_its_outputs():
    """``mx.sym._split_v2`` has one output a section, as the reference's,
    and evaluates to ``split_v2``'s parts."""
    from incubator_mxnet_tpu import symbol as jsym

    from incubator_mxnet_tpu_torch import symbol as tsym

    for kw in (dict(sections=5), dict(indices=(3, 7))):
        j = jsym._split_v2(jsym.var("data"), **kw)
        t = tsym._split_v2(tsym.var("data"), **kw)
        assert len(t.list_outputs()) == len(j.list_outputs())
        x = np.arange(10, dtype=np.float32)
        exe = t.bind(mx.cpu(), {"data": mx.nd.array(x, ctx=mx.cpu())})
        outs = exe.forward()
        want = jmx.nd._split_v2(jmx.nd.array(x), **kw)
        assert [o.shape for o in outs] == [w.shape for w in want]
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o.asnumpy(), w.asnumpy())


def test_im2col_col2im_adjoint():
    """col2im is the adjoint of im2col: <im2col(x), y> == <x, col2im(y)>."""
    nd = mx.nd
    cpu = mx.cpu()
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 6, 6).astype(np.float32)
    cols = nd.im2col(nd.array(x, ctx=cpu), kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1))
    y = rng.rand(*cols.shape).astype(np.float32)
    back = nd.col2im(nd.array(y, ctx=cpu), output_size=(6, 6),
                     kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    np.testing.assert_allclose(float((cols.asnumpy() * y).sum()),
                               float((x * back.asnumpy()).sum()), rtol=1e-5)


def test_straight_through_estimators_record():
    """The reference test's recorded calls, through ``mx.nd`` and
    ``autograd``: rounded values with an identity gradient, and a
    multiplied gradient."""
    nd, cpu = mx.nd, mx.cpu()
    x = nd.array(np.array([-1.4, 0.3, 2.6], np.float32), ctx=cpu)
    x.attach_grad()
    with mx.autograd.record():
        y = nd._contrib_round_ste(x)
    y.backward()
    np.testing.assert_array_equal(y.asnumpy(), [-1, 0, 3])
    np.testing.assert_array_equal(x.grad.asnumpy(), [1, 1, 1])
    x.attach_grad()
    with mx.autograd.record():
        z = nd._contrib_gradientmultiplier(x, scalar=0.5)
    z.backward()
    np.testing.assert_array_equal(z.asnumpy(), x.asnumpy())
    np.testing.assert_allclose(x.grad.asnumpy(), [0.5, 0.5, 0.5])


def test_box_encode_decode_roundtrip():
    nd, cpu = mx.nd, mx.cpu()
    targets, masks = nd._contrib_box_encode(
        nd.ones((1, 2), ctx=cpu), nd.array(np.array([[0, 1]], np.float32),
                                           ctx=cpu),
        nd.array(_ANCHORS, ctx=cpu), nd.array(_REFS, ctx=cpu))
    assert masks.asnumpy().all()
    decoded = nd._contrib_box_decode(targets, nd.array(_ANCHORS, ctx=cpu))
    np.testing.assert_allclose(decoded.asnumpy(), _REFS, atol=1e-5)


def test_hawkesll_gradients_reach_the_parameters():
    """The log-likelihood's gradients with respect to mu, alpha and beta
    through torch autograd equal the reference's ``jax.grad`` of its
    scans (relative 1e-5)."""
    import jax
    import jax.numpy as jnp

    fn = jreg.OPS["_contrib_hawkesll"].fn
    arrays = [np.asarray(a) for a in _HAWKES]
    want = jax.grad(lambda m, a, b: fn(m, a, b, *[jnp.asarray(x) for x in
                                                  arrays[3:]])[0].sum(),
                    argnums=(0, 1, 2))(*arrays[:3])
    ts = [torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(arrays)]
    treg.OPS["_contrib_hawkesll"].fn(*ts)[0].sum().backward()
    for t, w in zip(ts[:3], want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


#: name -> (attrs, mean, variance) of the *_like samplers
SAMPLERS = {
    "_random_uniform_like": (dict(low=2.0, high=3.0), 2.5, 1.0 / 12),
    "_random_normal_like": (dict(loc=5.0, scale=0.1), 5.0, 0.01),
    "_random_exponential_like": (dict(lam=4.0), 0.25, 1.0 / 16),
    "_random_gamma_like": (dict(alpha=3.0, beta=0.5), 1.5, 0.75),
    "_random_poisson_like": (dict(lam=3.5), 3.5, 3.5),
    "_random_negative_binomial_like": (dict(k=4, p=0.4), 6.0, 15.0),
    "_random_generalized_negative_binomial_like": (
        dict(mu=2.0, alpha=0.5), 2.0, 4.0),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_like_sampler_moments(name):
    """A ``*_like`` sampler draws the data's shape and dtype (the
    reference's), from the port's generator of the data's device: equal
    seeds draw equally, and 20000 draws lie within 6 standard errors of
    the distribution's mean and variance."""
    import jax

    attrs, mean, var = SAMPLERS[name]
    base = np.zeros((200, 100), np.float32)
    want = jreg.OPS[name].fn(jax.numpy.asarray(base[:2, :3]),
                             key=jax.random.PRNGKey(0), **attrs)
    fn = treg.OPS[name].fn
    mx.random.seed(7)
    a = fn(torch.tensor(base), **attrs)
    mx.random.seed(7)
    b = fn(torch.tensor(base), **attrs)
    assert torch.equal(a, b)
    assert a.shape == base.shape and str(a.numpy().dtype) == str(want.dtype)
    x = a.double().reshape(-1).numpy()
    n = x.size
    assert abs(x.mean() - mean) <= 6 * np.sqrt(var / n), (x.mean(), mean)
    assert abs(x.var() - var) <= 6 * np.sqrt(8 * var * var / n), \
        (x.var(), var)


def test_sample_unique_zipfian():
    """Distinct int64 candidates in [0, range_max) with the draw count,
    evaluated on the host as the reference's (``no_trace``); the numpy
    generator is seeded from the port's, so a seed repeats the draw."""
    import jax

    fn = treg.OPS["_sample_unique_zipfian"].fn
    assert treg.OPS["_sample_unique_zipfian"].no_trace
    mx.random.seed(3)
    cand, trials = fn(range_max=1000, shape=(64,), ctx="cpu")
    mx.random.seed(3)
    again, _ = fn(range_max=1000, shape=(64,), ctx="cpu")
    assert torch.equal(cand, again)
    ref = jreg.OPS["_sample_unique_zipfian"].fn(
        range_max=1000, shape=(64,), key=jax.random.PRNGKey(0))
    assert cand.dtype == torch.int64 and str(ref[0].dtype) == "int64"
    assert tuple(cand.shape) == tuple(ref[0].shape)
    assert tuple(trials.shape) == tuple(ref[1].shape)
    assert len(set(cand.tolist())) == 64
    assert int(cand.min()) >= 0 and int(cand.max()) < 1000
    assert int(trials[0]) >= 64
    # log-uniform: small candidates are the most frequent
    assert int((cand < 100).sum()) > int((cand >= 900).sum())


def test_shape_inference_of_the_new_ops():
    """``Op.infer`` answers each traceable op of this slice on ``meta``
    tensors with the reference's shapes and dtypes (``jax.eval_shape``)."""
    import jax

    from incubator_mxnet_tpu_torch.base import torch_dtype

    for case, (name, arrays, attrs) in sorted(CASES.items()):
        jop, top = jreg.OPS[name], treg.OPS[name]
        if jop.no_trace or name in ("_histogram", "histogram"):
            continue
        want = jop.infer([None if a is None else
                          jax.ShapeDtypeStruct(np.shape(a),
                                               np.asarray(a).dtype)
                          for a in arrays], **attrs)
        got = top.infer([None if a is None else
                         torch.empty(np.shape(a), dtype=torch_dtype(
                             np.asarray(a).dtype), device="meta")
                         for a in arrays], **attrs)
        want = want if isinstance(want, (tuple, list)) else [want]
        assert [tuple(g.shape) for g in got] == \
            [tuple(w.shape) for w in want], case
        assert [str(g.dtype).replace("torch.", "") for g in got] == \
            [str(np.dtype(w.dtype)) for w in want], case
