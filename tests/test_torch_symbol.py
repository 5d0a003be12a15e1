"""The symbolic front end (``mx.sym``, ``Executor``) and the registry
forms it composes, against the JAX package's.

- Each registry form's signature equals the reference's: the same
  inputs in the same order, then the same attributes with the same
  defaults (the reference's PRNG ``key`` of Dropout aside, which its own
  ``op_info`` hides too).  The scalar ops that ``Symbol`` arithmetic
  emits are all registered.
- Composition: auto-created variables, ``list_arguments``/
  ``list_auxiliary_states``/``list_outputs``, ``infer_shape``,
  ``infer_shape_partial`` and ``infer_type`` equal on a BN graph and on
  multi-output nodes; ``tojson`` byte for byte, and each package loads
  the other's JSON.
- ``simple_bind`` forward and backward of every form (with its
  options: ``flatten=False``, ``no_bias``, grouped/dilated/1-D
  convolution, every pooling type incl. lp, global and ceil mode, BN in
  training with its running-stat update and with
  ``use_global_stats``, each activation, SoftmaxOutput's
  normalizations, ignore label, multi-output, preserve-shape, label
  smoothing and ``out_grad``, ``pick``, the scalar arithmetic) against
  the JAX executor on the same inputs; ``grad_req="add"``.
- ``Dropout(mode="always")`` drops in inference too, and Gluon's
  ``Dense(flatten=False)`` matches the reference's.
- The executor's monitor callback, ``reshape`` and ``eval``.
- K3's wrapper answers ``meta`` tensors (shape inference) with empty
  outputs of the checked shape, without the plain version and without a
  launch.

Tolerances (f32): 1e-5 relative to each array's largest magnitude
(sums in another order), 1e-6 absolute floor; max pooling exact.
"""
import inspect

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()

FORMS = ["FullyConnected", "Convolution", "Pooling", "BatchNorm",
         "Activation", "Dropout", "SoftmaxOutput", "pick"]
SCALAR_OPS = ["_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_power_scalar",
              "_rpower_scalar", "_mod_scalar", "_rmod_scalar",
              "_maximum_scalar", "_minimum_scalar", "_equal_scalar",
              "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar", "_PlusScalar", "_MinusScalar",
              "_MulScalar", "_DivScalar"]


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters
            .values() if p.name != "key"]


@pytest.mark.parametrize("name", FORMS + SCALAR_OPS)
def test_form_signature_matches_reference(name):
    assert _params(treg.get_op(name).fn) == _params(jreg.get_op(name).fn)


def _both(build):
    """``build(sym)`` in each package, each under a fresh NameManager."""
    with jmx.name.NameManager():
        js = build(jmx.sym)
    with tmx.name.NameManager():
        ts = build(tmx.sym)
    return js, ts


def _bn_net(S):
    x = S.Convolution(S.var("data"), kernel=(3, 3), num_filter=4,
                      name="conv")
    x = S.BatchNorm(x, fix_gamma=False, name="bn")
    x = S.Activation(x, act_type="relu")
    x = S.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = S.FullyConnected(S.Flatten(x), num_hidden=3, name="fc")
    return S.SoftmaxOutput(x, name="softmax")


def _multi_out(S):
    bn = S.BatchNorm(S.var("data"), output_mean_var=True, name="bn")
    return S.Group([bn[0] * 2.0, bn[2], S.pick(S.var("data"),
                                               S.var("index"), axis=1)])


@pytest.mark.parametrize("build,shapes", [
    (_bn_net, {"data": (2, 3, 10, 10)}),
    (_multi_out, {"data": (4, 3), "index": (4,)}),
])
def test_composition_and_inference_match(build, shapes):
    js, ts = _both(build)
    assert ts.tojson() == js.tojson()
    for f in ("list_arguments", "list_auxiliary_states", "list_outputs",
              "list_inputs"):
        assert getattr(ts, f)() == getattr(js, f)(), f
    assert ts.get_internals().list_outputs() == \
        js.get_internals().list_outputs()
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    assert ts.infer_type(**{k: "float32" for k in shapes}) == \
        js.infer_type(**{k: "float32" for k in shapes})
    partial = {k: v for k, v in list(shapes.items())[1:]}
    assert ts.infer_shape_partial(**partial) == \
        js.infer_shape_partial(**partial)


def test_infer_type_with_shaped_variables():
    def build(S):
        x = S.var("x", shape=(2, 3), dtype="float16")
        return S.FullyConnected(x, num_hidden=4, name="fc") + 1.0

    js, ts = _both(build)
    assert ts.infer_type() == js.infer_type()
    assert ts.infer_type()[1][0] == np.float16


def test_infer_shape_refuses_unresolved_inputs():
    _, ts = _both(lambda S: S.FullyConnected(S.var("data"), num_hidden=4))
    with pytest.raises(tmx.base.MXNetError, match="cannot resolve"):
        ts.infer_shape()
    assert ts.infer_shape_partial() == ([None, None, None], [None], [])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_json_files_cross_both_ways(tmp_path, writer):
    js, ts = _both(_bn_net)
    path = str(tmp_path / "net-symbol.json")
    (js if writer == "jax" else ts).save(path)
    loaded = (tmx.sym if writer == "jax" else jmx.sym).load(path)
    assert loaded.tojson() == open(path).read()
    assert loaded.list_arguments() == js.list_arguments()
    assert loaded.infer_shape(data=(2, 3, 10, 10)) == \
        js.infer_shape(data=(2, 3, 10, 10))


def _close(got, want, exact=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0)))
        np.testing.assert_allclose(got, want, rtol=0, atol=max(tol, 1e-6))


def _bind_pair(build, shapes, values=None, grad_req="write", seed=0):
    """Both symbols bound by ``simple_bind`` on the CPU to the same
    inputs: normal draws (running variances positive), overridden by
    ``values``."""
    js, ts = _both(build)
    jex = js.simple_bind(jmx.cpu(), grad_req=grad_req, **shapes)
    tex = ts.simple_bind(CPU, grad_req=grad_req, **shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.normal(size=a.shape).astype(np.float32)
            for n, a in tex.arg_dict.items()}
    aux = {n: (np.abs(rng.normal(size=a.shape)) + 0.5 if n.endswith("var")
               else rng.normal(size=a.shape)).astype(np.float32)
           for n, a in tex.aux_dict.items()}
    args.update(values or {})
    jex.copy_params_from({n: jmx.nd.array(v) for n, v in args.items()},
                         {n: jmx.nd.array(v) for n, v in aux.items()})
    tex.copy_params_from({n: tmx.nd.array(v, ctx=CPU)
                          for n, v in args.items()},
                         {n: tmx.nd.array(v, ctx=CPU)
                          for n, v in aux.items()})
    return jex, tex


def _run_pair(build, shapes, values=None, is_train=True, head=True,
              exact=False, grad_req="write", steps=1):
    jex, tex = _bind_pair(build, shapes, values, grad_req)
    rng = np.random.RandomState(7)
    for _ in range(steps):
        jout = jex.forward(is_train=is_train)
        tout = tex.forward(is_train=is_train)
        for j, t in zip(jout, tout):
            _close(t.asnumpy(), j.asnumpy(), exact)
        if not is_train:
            continue
        if head:
            heads = [rng.normal(size=o.shape).astype(np.float32)
                     for o in tout]
            jex.backward([jmx.nd.array(h) for h in heads])
            tex.backward([tmx.nd.array(h, ctx=CPU) for h in heads])
        else:
            jex.backward()
            tex.backward()
        for n, g in tex.grad_dict.items():
            _close(g.asnumpy(), jex.grad_dict[n].asnumpy(), exact)
    for n, a in tex.aux_dict.items():
        _close(a.asnumpy(), jex.aux_dict[n].asnumpy())
    return jex, tex


def _op(name, **attrs):
    return lambda S: getattr(S, name)(S.var("data"), name="op", **attrs)


@pytest.mark.parametrize("build,shape", [
    (_op("FullyConnected", num_hidden=5), (4, 3, 2)),
    (_op("FullyConnected", num_hidden=5, flatten=False), (4, 3, 6)),
    (_op("FullyConnected", num_hidden=5, no_bias=True), (4, 6)),
    (_op("Convolution", kernel=(3, 3), num_filter=4, stride=(2, 2),
         pad=(1, 1)), (2, 3, 9, 9)),
    (_op("Convolution", kernel=(3, 3), num_filter=4, num_group=2,
         dilate=(2, 2), no_bias=True), (2, 4, 9, 9)),
    (_op("Convolution", kernel=(3,), num_filter=4), (2, 3, 10)),
    (_op("Pooling", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pool_type="avg"), (2, 3, 9, 9)),
    (_op("Pooling", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pool_type="avg", count_include_pad=False), (2, 3, 9, 9)),
    (_op("Pooling", kernel=(2, 2), stride=(2, 2), pool_type="sum"),
     (2, 3, 8, 8)),
    (_op("Pooling", kernel=(2, 2), stride=(2, 2), pool_type="lp"),
     (2, 3, 8, 8)),
    (_op("Pooling", kernel=(3, 3), stride=(1, 1), pad=(1, 1), p_value=3,
         pool_type="lp"), (2, 3, 7, 7)),
    (_op("Pooling", kernel=(1, 1), global_pool=True, pool_type="avg"),
     (2, 3, 5, 5)),
    (_op("Pooling", kernel=(1, 1), global_pool=True, pool_type="lp"),
     (2, 3, 5, 5)),
    (_op("Pooling", kernel=(3, 3), stride=(2, 2), pool_type="avg",
         pooling_convention="full"), (2, 3, 8, 8)),
    (_op("Activation", act_type="tanh"), (3, 5)),
    (_op("Activation", act_type="sigmoid"), (3, 5)),
    (_op("Activation", act_type="softrelu"), (3, 5)),
    (_op("Activation", act_type="softsign"), (3, 5)),
    (_op("Dropout", p=0.0), (3, 5)),
])
def test_forms_forward_and_backward_match(build, shape):
    _run_pair(build, {"data": shape})


@pytest.mark.parametrize("kw,shape", [
    (dict(kernel=(2, 2), stride=(2, 2)), (2, 3, 8, 8)),
    (dict(kernel=(3, 3), stride=(2, 2), pooling_convention="full"),
     (2, 3, 8, 8)),
    (dict(kernel=(1, 1), stride=(1, 1)), (2, 3, 6, 6)),
    (dict(kernel=(12, 12), stride=(1, 1)), (2, 3, 16, 16)),
    (dict(kernel=(1, 1), global_pool=True), (2, 3, 5, 5)),
])
def test_max_pooling_form_is_exact(kw, shape):
    """Max pooling on quarter-step values with ReLU-style ties: outputs
    and the first-argmax gradient bit for bit, on K3's route (2x2,
    ceil-mode 3x3) and the stock route (1 and 144 window slots)."""
    x = np.maximum(np.round(np.random.RandomState(3).normal(size=shape) * 4)
                   / 4, 0).astype(np.float32)
    _run_pair(_op("Pooling", pool_type="max", **kw), {"data": shape},
              {"data": x}, exact=True)


def test_relu_activation_matches_off_ties():
    x = np.random.RandomState(1).normal(size=(3, 5)).astype(np.float32)
    _run_pair(_op("Activation", act_type="relu"), {"data": x.shape},
              {"data": x})


@pytest.mark.parametrize("kw", [
    dict(fix_gamma=False),
    dict(fix_gamma=True, momentum=0.8, eps=1e-5),
    dict(fix_gamma=False, use_global_stats=True),
])
def test_batch_norm_form_and_running_stats_match(kw):
    """Training forward and backward, and the running-stat update that
    the executor commits (MXNet's momentum, biased one-pass variance),
    over two steps; with ``use_global_stats`` the moving stats normalize
    and stay."""
    _run_pair(_op("BatchNorm", **kw), {"data": (4, 3, 5, 5)}, steps=2)


def test_batch_norm_inference_and_output_mean_var():
    _run_pair(_op("BatchNorm", fix_gamma=False), {"data": (4, 3, 5, 5)},
              is_train=False)
    jex, tex = _bind_pair(_op("BatchNorm", output_mean_var=True),
                          {"data": (4, 3, 5, 5)})
    for j, t in zip(jex.forward(is_train=True), tex.forward(is_train=True)):
        _close(t.asnumpy(), j.asnumpy())


def _softmax(**kw):
    return lambda S: S.SoftmaxOutput(S.var("data"), S.var("label"),
                                     name="softmax", **kw)


_LABEL = np.array([0, 2, -1, 1, 3, -1], np.float32)


@pytest.mark.parametrize("kw,shapes,label", [
    ({}, {"data": (6, 4), "label": (6,)}, np.abs(_LABEL)),
    (dict(grad_scale=0.5, normalization="batch"),
     {"data": (6, 4), "label": (6,)}, np.abs(_LABEL)),
    (dict(use_ignore=True, normalization="valid"),
     {"data": (6, 4), "label": (6,)}, _LABEL),
    (dict(use_ignore=True, ignore_label=3.0),
     {"data": (6, 2, 2), "label": (6,)}, np.abs(_LABEL)),
    (dict(smooth_alpha=0.1), {"data": (6, 4), "label": (6,)},
     np.abs(_LABEL)),
    (dict(multi_output=True, use_ignore=True),
     {"data": (2, 4, 3), "label": (2, 3)}, _LABEL.reshape(2, 3)),
    (dict(preserve_shape=True, smooth_alpha=0.2, use_ignore=True),
     {"data": (2, 3, 4), "label": (2, 3)}, _LABEL.reshape(2, 3)),
])
def test_softmax_output_matches(kw, shapes, label):
    """The gradient is ``(p - onehot) * scale`` whatever the head
    gradient, with each option; the label gets none."""
    _run_pair(_softmax(**kw), shapes, {"label": label})
    _run_pair(_softmax(**kw), shapes, {"label": label}, head=False)


def test_softmax_output_out_grad_takes_the_head_gradient():
    _run_pair(_softmax(out_grad=True), {"data": (6, 4), "label": (6,)},
              {"label": np.abs(_LABEL)})


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (0, True)])
def test_pick_matches(axis, keepdims):
    def build(S):
        return S.pick(S.var("data"), S.var("index"), axis=axis,
                      keepdims=keepdims, name="pick")

    shapes = {"data": (4, 5), "index": (5,) if axis == 0 else (4,)}
    index = np.array([0, 3, 7, -1, 2][:shapes["index"][0]], np.float32)
    _run_pair(build, shapes, {"index": index})


def test_symbol_arithmetic_matches():
    def build(S):
        x = S.var("data")
        y = S.var("other")
        return S.Group([(x * 2 + 1) / 3 - x ** 2, 2 - x, 1 / (y * y + 3),
                        -x + y, x / y * 0.5])

    _run_pair(build, {"data": (3, 4), "other": (3, 4)})


def test_symbol_comparisons_match():
    def build(S):
        x = S.var("data")
        return S.Group([x > 0.5, 0.5 > x, x <= 0.0, 1.0 <= x, x == 1.0,
                        x != 1.0, x >= -0.5])

    x = np.round(np.random.RandomState(2).normal(size=(3, 4)) * 2) / 2
    _run_pair(build, {"data": (3, 4)}, {"data": x.astype(np.float32)},
              is_train=False)


def test_grad_req_add_accumulates():
    _run_pair(_bn_net, {"data": (2, 3, 10, 10), "softmax_label": (2,)},
              {"softmax_label": np.array([0, 2], np.float32)},
              grad_req="add", head=False, steps=2)


def test_dropout_always_drops_in_inference():
    """``mode="always"``: inference drops too (kept entries scaled by 1 /
    (1 - p), about half of them at p 0.5); the default mode leaves
    inference alone, as the reference does."""
    x = np.random.RandomState(0).normal(size=(64, 64)).astype(np.float32)
    _run_pair(_op("Dropout", p=0.5), {"data": x.shape}, {"data": x},
              is_train=False)
    _, ts = _both(_op("Dropout", p=0.5, mode="always"))
    tmx.random.seed(1)
    out = ts.eval(data=tmx.nd.array(x, ctx=CPU)).asnumpy()
    kept = out != 0
    np.testing.assert_array_equal(out[kept], x[kept] * 2)
    assert 0.45 < kept.mean() < 0.55
    # the draw shared along axes
    _, ts = _both(_op("Dropout", p=0.5, mode="always", axes=(1,)))
    out = ts.eval(data=tmx.nd.array(x, ctx=CPU)).asnumpy()
    assert ((out != 0) == (out[:, :1] != 0)).all()


def test_gluon_dense_without_flatten_matches():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 3, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    dense = tmx.gluon.nn.Dense(4, flatten=False, device="cpu")
    dense.shape_init((1, 3, 5))
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w))
        dense.bias.copy_(torch.from_numpy(b))
    got = dense(tmx.nd.array(x, ctx=CPU)).asnumpy()
    want = jmx.nd.FullyConnected(jmx.nd.array(x), jmx.nd.array(w),
                                 jmx.nd.array(b), num_hidden=4,
                                 flatten=False).asnumpy()
    assert got.shape == (2, 3, 4)
    _close(got, want)


def test_monitor_sees_every_output():
    def names(pkg):
        seen = []
        with pkg.name.NameManager():
            s = _bn_net(pkg.sym)
        ex = s.simple_bind(pkg.cpu(), data=(2, 3, 10, 10))
        ex.set_monitor_callback(lambda n, a: seen.append(n), monitor_all=True)
        ex.forward(is_train=False)
        return seen

    assert names(tmx) == names(jmx)


def test_executor_reshape_and_eval():
    _, ts = _both(_bn_net)
    ex = ts.simple_bind(CPU, data=(2, 3, 10, 10))
    ex2 = ex.reshape(data=(5, 3, 10, 10))
    assert ex2.arg_dict["conv_weight"] is ex.arg_dict["conv_weight"]
    assert ex2.forward()[0].shape == (5, 3)
    x = tmx.nd.array(np.ones((1, 3, 4), np.float32), ctx=CPU)
    y = (tmx.sym.var("a") * 2.0).eval(a=x)
    np.testing.assert_array_equal(y.asnumpy(), 2 * np.ones((1, 3, 4)))


def test_kernel_wrappers_answer_meta_tensors(monkeypatch):
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import maxpool_idx

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta tensors")

    monkeypatch.setattr(maxpool_idx, "_maxpool_plain", refuse)
    before = _kernels.launch_counts()
    x = torch.empty(8, 4, 6, 6, device="meta")
    out, idx = maxpool_idx.maxpool_with_index(
        x, (1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
    assert out.shape == idx.shape == (8, 4, 3, 3) and idx.dtype == torch.int8
    with pytest.raises(ValueError, match="window slots"):
        maxpool_idx.maxpool_with_index(x, (1, 1, 1, 1), (1, 1, 1, 1),
                                       ((0, 0),) * 4)
    assert _kernels.launch_counts() == before


def test_init_symbols_match():
    """``sym.zeros``/``ones``/``arange`` build on the executor's device."""
    def build(S):
        x = S.var("data")
        return S.Group([S.zeros((2, 3)) + x, S.ones((2, 3)) * 2.0,
                        S.arange(1, 7, 2), S.arange(4, repeat=2)])

    jex, tex = _run_pair(build, {"data": (2, 3)}, is_train=False)
    js, ts = _both(build)
    assert ts.infer_shape(data=(2, 3)) == js.infer_shape(data=(2, 3))
    assert all(o.context == CPU for o in tex.outputs)
    assert tex.output_dict.keys() == jex.output_dict.keys()


def test_outputs_without_gradient_give_zero_gradients():
    def build(S):
        return S.BlockGrad(S.var("data") * 2.0, name="stop")

    _run_pair(build, {"data": (3, 4)})
