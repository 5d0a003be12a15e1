"""The detection contrib ops of ``incubator_mxnet_tpu_torch/ops/contrib.py``
against the JAX package's (``incubator_mxnet_tpu/ops/contrib.py``), on
the CPU.

The same f32 inputs, drawn from numpy seeds, go through the reference's
op (``jax.jit`` of its registered function) and the port's.  Limits:
class ids, masks, class targets, matches and kept rows equal; anchors
and IoUs within 1e-6; location targets, decoded boxes and the ROI ops
(forward and the gradient of the input) within 1e-5.  Output dtypes are
the reference's (``bipartite_matching`` is float64: the reference runs
with ``jax_enable_x64``).  Cases with tied IoUs, tied and zero scores and
padded or absent labels are built on purpose.  Shape inference on
``meta`` tensors and ``mx.sym.contrib`` are held to the reference's
``jax.eval_shape`` and ``mx.sym.contrib``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import registry as treg

NAMES = {
    "_contrib_MultiBoxPrior": ("MultiBoxPrior",),
    "_contrib_MultiBoxTarget": ("MultiBoxTarget",),
    "_contrib_MultiBoxDetection": ("MultiBoxDetection",),
    "_contrib_box_iou": ("box_iou",),
    "_contrib_box_nms": ("box_nms",),
    "_contrib_bipartite_matching": ("bipartite_matching",),
    "ROIPooling": (),
    "_contrib_ROIAlign": ("ROIAlign",),
}


def _ref(name, *arrays, **kw):
    out = jax.jit(functools.partial(jreg.OPS[name].fn, **kw))(
        *[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else [out])]


def _port(name, *arrays, **kw):
    out = treg.OPS[name].fn(*[torch.from_numpy(np.array(a))
                              for a in arrays], **kw)
    return [o.numpy() for o in (out if isinstance(out, (tuple, list))
                                else [out])]


def _both(name, *arrays, **kw):
    want = _ref(name, *arrays, **kw)
    got = _port(name, *arrays, **kw)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    return got, want


def _anchors(h=5, w=6, sizes=(0.3, 0.5), ratios=(1.0, 2.0)):
    return _ref("_contrib_MultiBoxPrior", np.zeros((1, 3, h, w), np.float32),
                sizes=sizes, ratios=ratios)[0]


def _labels(rng, n, width, counts):
    lab = np.full((n, width, 5), -1.0, np.float32)
    for i, c in enumerate(counts):
        for k in range(c):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.4 + 0.05
            lab[i, k] = [rng.randint(0, 3), x0, y0, x0 + w, y0 + h]
    return lab


def test_registry_names_and_flags_match_reference():
    for name, aliases in NAMES.items():
        top, ref = treg.OPS[name], jreg.OPS[name]
        assert top.name == ref.name == name
        assert top.aliases == ref.aliases == aliases
        for a in aliases:
            assert treg.OPS[a] is top
        assert (top.num_inputs, top.num_outputs, top.differentiable) == \
            (ref.num_inputs, ref.num_outputs, ref.differentiable)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.7, 0.9), ratios=(1.0, 3.0), clip=True),
    dict(sizes="(0.2, 0.272)", ratios="[1, 2, 0.5, 3, 0.3333]",
         steps=(0.125, 0.1), offsets=(0.25, 0.75)),
])
def test_multibox_prior(kw):
    got, want = _both("_contrib_MultiBoxPrior",
                      np.zeros((2, 3, 5, 7), np.float32), **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    if kw.get("clip"):
        assert got[0].min() >= 0 and got[0].max() <= 1


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(1)
    lhs = rng.rand(2, 6, 4).astype(np.float32)
    rhs = rng.rand(5, 4).astype(np.float32)
    lhs[0, 0] = [0.2, 0.2, 0.2, 0.2]      # zero area: union 0 against itself
    rhs[0] = lhs[0, 0]
    rhs[1] = lhs[1, 2]                    # an exact match: IoU 1
    got, want = _both("_contrib_box_iou", lhs, rhs, format=fmt)
    assert got[0].shape == (2, 6, 5)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def _target_case(case):
    rng = np.random.RandomState(2)
    anchors = _anchors()
    a = anchors.shape[1]
    kw = {}
    if case == "no_gt":
        lab = np.full((3, 4, 5), -1.0, np.float32)
    elif case == "padded":
        lab = _labels(rng, 3, 6, [1, 0, 4])   # image 1 has no box at all
    elif case == "tied":
        # two identical anchors and two identical boxes: every IoU max ties
        anchors = anchors.copy()
        anchors[0, 5] = anchors[0, 4]
        lab = _labels(rng, 2, 4, [2, 3])
        lab[0, 0, 1:] = anchors[0, 4]
        lab[0, 1] = lab[0, 0]
        lab[1, 2] = lab[1, 0]
    else:
        lab = _labels(rng, 3, 4, [2, 4, 3])
    cp = rng.randn(lab.shape[0], 4, a).astype(np.float32)
    if case == "tied":
        cp[:, :, 7] = cp[:, :, 3]          # tied background probabilities
    if case == "mining":
        kw = dict(negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    elif case == "mining_min":
        kw = dict(negative_mining_ratio=0.5, negative_mining_thresh=0.4,
                  minimum_negative_samples=20, overlap_threshold=0.3,
                  ignore_label=-2.0, variances=(0.1, 0.2, 0.3, 0.4))
    elif case in ("tied", "padded"):
        kw = dict(negative_mining_ratio=3.0)
    return anchors, lab, cp, kw


@pytest.mark.parametrize("case", ["plain", "mining", "mining_min", "no_gt",
                                  "padded", "tied"])
def test_multibox_target(case):
    anchors, lab, cp, kw = _target_case(case)
    got, want = _both("_contrib_MultiBoxTarget", anchors, lab, cp, **kw)
    loc_t, loc_mask, cls_t = got
    np.testing.assert_array_equal(cls_t, want[2])
    np.testing.assert_array_equal(loc_mask, want[1])
    np.testing.assert_allclose(loc_t, want[0], rtol=0, atol=1e-5)
    if case == "no_gt":
        assert (cls_t == -1).all() and not loc_mask.any()
    else:
        assert (cls_t > 0).any()
    if "mining" in case:
        assert (cls_t == 0).any() and (cls_t == kw.get("ignore_label",
                                                       -1)).any()


def _detect_case(case):
    rng = np.random.RandomState(3)
    anchors = _anchors(6, 6)
    a = anchors.shape[1]
    n, c = 3, 4
    logits = rng.randn(n, c, a).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(n, a * 4) * 0.3).astype(np.float32)
    kw = dict(nms_threshold=0.3)
    if case == "force":
        kw.update(force_suppress=True)
    elif case == "topk":
        kw.update(nms_topk=15, threshold=0.2)
    elif case == "background":
        kw.update(background_id=2, clip=False, variances=(0.2, 0.2, 0.1, 0.1))
    elif case == "zero_and_tied":
        # zero scores kept (threshold 0) and tied scores
        prob[:, :, :10] = 0.0
        prob[:, 0, :10] = 1.0
        prob[:, 1:, 10:40] = prob[:, 1:, 40:70]
        kw.update(threshold=0.0, nms_threshold=0.5)
    return prob.astype(np.float32), loc, anchors, kw


@pytest.mark.parametrize("case", ["plain", "force", "topk", "background",
                                  "zero_and_tied"])
def test_multibox_detection(case):
    prob, loc, anchors, kw = _detect_case(case)
    got, want = _both("_contrib_MultiBoxDetection", prob, loc, anchors, **kw)
    np.testing.assert_array_equal(got[0][..., 0], want[0][..., 0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    kept = got[0][..., 0] >= 0
    assert kept.any() and not kept.all()
    if case == "topk":
        assert kept.sum(1).max() <= 15


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.3),
    dict(overlap_thresh=0.4, id_index=0, topk=12, out_format="center"),
    dict(overlap_thresh=0.4, id_index=0, background_id=1, valid_thresh=0.2,
         in_format="center", out_format="corner"),
    dict(overlap_thresh=0.5, id_index=0, force_suppress=True, coord_start=2,
         score_index=1),
])
def test_box_nms(kw):
    rng = np.random.RandomState(4)
    n = 40
    rows = np.concatenate([
        rng.randint(0, 3, (2, n, 1)).astype(np.float32),
        rng.rand(2, n, 1).astype(np.float32),
        rng.rand(2, n, 2).astype(np.float32) * 0.5,
        rng.rand(2, n, 2).astype(np.float32) * 0.5 + 0.3], axis=-1)
    rows[:, 5:9] = rows[:, 0:4]           # tied scores on identical boxes
    rows[:, 12, 1] = rows[:, 11, 1]       # tied scores, distinct boxes
    got, want = _both("_contrib_box_nms", rows, **kw)
    np.testing.assert_array_equal(got[0] == -1, want[0] == -1)
    np.testing.assert_array_equal(got[0][..., :2], want[0][..., :2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert (got[0][..., 1] != -1).any() and (got[0][..., 1] == -1).any()


@pytest.mark.parametrize("kw", [dict(), dict(threshold=0.4),
                                dict(is_ascend=True),
                                dict(is_ascend=True, threshold=0.5)])
def test_bipartite_matching(kw):
    rng = np.random.RandomState(5)
    d = rng.rand(3, 5, 7).astype(np.float32)
    d[0, 1] = d[0, 3]                      # tied rows
    d[1, :, 2] = d[1, :, 4]                # tied columns
    for dist in (d, d.transpose(0, 2, 1).copy()):
        got, want = _both("_contrib_bipartite_matching", dist, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _roi_inputs(ties):
    rng = np.random.RandomState(6)
    data = rng.randn(2, 3, 12, 14).astype(np.float32)
    if ties:
        data = np.round(data * 2).astype(np.float32)
    rois = np.array([[0, 1, 2, 9, 10], [1, 0, 0, 13, 11],
                     [0, 3.5, 2.2, 7.7, 6.1], [1, 10, 8, 10, 8]],
                    np.float32)
    return data, rois


@pytest.mark.parametrize("name,kw,ties", [
    ("ROIPooling", dict(pooled_size=(3, 2), spatial_scale=0.9), False),
    ("ROIPooling", dict(pooled_size=(2, 2), spatial_scale=1.0), True),
    ("_contrib_ROIAlign", dict(pooled_size=(3, 2), spatial_scale=0.9),
     False),
    ("_contrib_ROIAlign", dict(pooled_size=(2, 2), spatial_scale=0.5,
                               sample_ratio=3, aligned=True), False),
])
def test_roi_ops_forward_and_input_gradient(name, kw, ties):
    data, rois = _roi_inputs(ties)
    got, want = _both(name, data, rois, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    w = np.random.RandomState(7).randn(*want[0].shape).astype(np.float32)

    def loss(d):
        return jnp.sum(jreg.OPS[name].fn(d, jnp.asarray(rois), **kw) * w)

    gwant = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_()
    (treg.OPS[name].fn(x, torch.from_numpy(rois), **kw)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), gwant, rtol=0, atol=1e-5)
    assert np.abs(gwant).max() > 0


def _meta_cases():
    anchors = np.zeros((1, 120, 4), np.float32)
    return [
        ("_contrib_MultiBoxPrior", [((2, 3, 5, 6), "float32")],
         dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0))),
        ("_contrib_MultiBoxTarget", [(anchors.shape, "float32"),
                                     ((3, 4, 5), "float32"),
                                     ((3, 4, 120), "float32")], {}),
        ("_contrib_MultiBoxDetection", [((3, 4, 120), "float32"),
                                        ((3, 480), "float32"),
                                        (anchors.shape, "float32")], {}),
        ("_contrib_box_iou", [((2, 6, 4), "float32"), ((5, 4), "float32")],
         {}),
        ("_contrib_box_nms", [((2, 40, 6), "float32")], dict(id_index=0)),
        ("_contrib_bipartite_matching", [((3, 5, 7), "float32")], {}),
        ("ROIPooling", [((2, 3, 12, 14), "float32"), ((4, 5), "float32")],
         dict(pooled_size=(3, 2))),
        ("_contrib_ROIAlign", [((2, 3, 12, 14), "float32"),
                               ((4, 5), "float32")],
         dict(pooled_size=(3, 2))),
    ]


@pytest.mark.parametrize("name,ins,kw", _meta_cases())
def test_meta_inference_matches_eval_shape(name, ins, kw):
    want = jreg.OPS[name].infer(
        [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in ins], **kw)
    got = treg.OPS[name].infer(
        [torch.empty(s, dtype=getattr(torch, d), device="meta")
         for s, d in ins], **kw)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [str(g.dtype).replace("torch.", "") for g in got] == \
        [str(w.dtype) for w in want]


def test_sym_contrib_matches_reference():
    with jmx.name.NameManager():
        js = jmx.sym.contrib.MultiBoxPrior(jmx.sym.var("data"),
                                           sizes=(0.3, 0.5),
                                           ratios=(1.0, 2.0))
        jt = jmx.sym.contrib.MultiBoxTarget(
            jmx.sym.var("a"), jmx.sym.var("l"), jmx.sym.var("c"))
    with tmx.name.NameManager():
        ts = tmx.sym.contrib.MultiBoxPrior(tmx.sym.var("data"),
                                           sizes=(0.3, 0.5),
                                           ratios=(1.0, 2.0))
        tt = tmx.sym.contrib.MultiBoxTarget(
            tmx.sym.var("a"), tmx.sym.var("l"), tmx.sym.var("c"))
    assert ts.infer_shape(data=(1, 3, 4, 4)) == \
        js.infer_shape(data=(1, 3, 4, 4))
    shapes = dict(a=(1, 48, 4), l=(2, 3, 5), c=(2, 4, 48))
    assert tt.list_outputs() == jt.list_outputs()
    assert tt.infer_shape(**shapes) == jt.infer_shape(**shapes)
    # the control flow composes in mx.sym.contrib too, as the reference's
    with jmx.name.NameManager():
        jf = jmx.sym.contrib.foreach(lambda x, s: (x + s, x + s),
                                     jmx.sym.var("d"), jmx.sym.var("s"))[0]
    with tmx.name.NameManager():
        tf = tmx.sym.contrib.foreach(lambda x, s: (x + s, x + s),
                                     tmx.sym.var("d"), tmx.sym.var("s"))[0]
    assert tf.tojson() == jf.tojson()


def test_nd_contrib_runs_the_ops():
    feat = np.zeros((1, 3, 4, 4), np.float32)
    got = tmx.nd.contrib.MultiBoxPrior(tmx.nd.array(feat, ctx=tmx.cpu()),
                                       sizes=(0.3,), ratios=(1.0, 2.0))
    want = jmx.nd.contrib.MultiBoxPrior(jmx.nd.array(feat), sizes=(0.3,),
                                        ratios=(1.0, 2.0))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=0,
                               atol=1e-6)


def test_sorts_agree_on_signed_zeros_and_nan():
    """The ops' descending sorts are stable ascending sorts of the negated
    key on both sides: ``jnp.argsort`` and ``torch.sort`` both treat -0.0
    and 0.0 as equal (ties keep index order) and put NaN of either sign
    last, so a 0.0 score, negated to -0.0, needs no total-order key."""
    x = np.array([0.0, -0.0, 0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                  1.0], np.float32)
    for key in (x, -x):
        want = np.asarray(jnp.argsort(jnp.asarray(key), stable=True))
        got = torch.sort(torch.from_numpy(key), stable=True).indices
        np.testing.assert_array_equal(got.numpy(), want)
