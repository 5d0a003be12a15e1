"""The port's ``ops/contrib_tail.py`` against the JAX package's, on the CPU:
the warping family, ``Crop``, ``Correlation``, the deformable ops, the
RPN's ``Proposal``/``MultiProposal``, ``SyncBatchNorm``, the transformer's
fused matmuls, ``fft``/``ifft``, ``count_sketch``, ``boolean_mask``,
``index_copy`` and ``index_array``.

Every case of the reference's ``tests/test_contrib_tail2.py`` is a case
here, with more modes of the same ops, fed the same numpy arrays on both
sides (``torch_op_parity``): forward, and the gradient of a fixed random
projection where the op is differentiable.  The index outputs are
equal; float ops within 1e-5 of the output's largest magnitude (at least
1e-5 absolute) in float32.  Of ``Proposal``, what NMS decides is equal:
the scores in their picked order and the rois' batch indices.  Its box
coordinates are within one float32 ULP of the largest box side the
decode's ``exp`` gives before clipping, plus one of the image's larger
side: XLA's CPU ``exp`` is not correctly rounded (about 1 float32 in 10
differs in the last bit from the correctly rounded value, which the
port takes), and a box side's last bit moves its corners by up to half
of it.  ``MultiProposal-sized`` meets such values, and its rois are
not bit-equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import contrib_tail as jcontrib
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import registry as treg

from torch_op_parity import check, port, reference

_RNG = np.random.RandomState(47)


def _n(*shape):
    return _RNG.normal(0.0, 1.0, shape).astype(np.float32)


def _u(lo, hi, *shape):
    return _RNG.uniform(lo, hi, shape).astype(np.float32)


_IDENT = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
_SPOT = np.zeros((1, 1, 5, 5), np.float32)
_SPOT[0, 0, 2, 2] = 1.0
_FRAC = np.zeros((1, 1, 4, 4), np.float32)
_FRAC[0, 0, 1, 1], _FRAC[0, 0, 1, 2] = 1.0, 3.0
_FRAC_OFF = np.zeros((1, 2, 4, 4), np.float32)
_FRAC_OFF[0, 1] = 0.5
_CORR = _u(0, 1, 1, 4, 6, 6)


def _rpn(n, a, fh, fw, spread, sized=True):
    """RPN inputs; without ``sized`` the width and height deltas are 0."""
    rng = np.random.RandomState(4 + n)
    cls = rng.rand(n, 2 * a, fh, fw).astype(np.float32)
    bbox = (rng.rand(n, 4 * a, fh, fw).astype(np.float32) - 0.5) * spread
    if not sized:
        bbox.reshape(n, a, 4, fh, fw)[:, :, 2:] = 0.0
    return cls, bbox


_RPN1 = _rpn(1, 3, 4, 4, 0.1)
_RPN2 = _rpn(2, 9, 6, 7, 0.5)
_RPN2_MOVED = _rpn(2, 9, 6, 7, 2.0, sized=False)
_RPN2_SIZED = _rpn(2, 9, 6, 7, 1.0)
# ties: equal foreground scores across anchors and positions
_RPN_TIES = (np.round(_RPN2[0] * 4) / 4, _RPN2_MOVED[1])
# the identity grid of the sampler case: the reference GridGenerator's
_IDENT_GRID = np.asarray(jreg.OPS["GridGenerator"].fn(
    _IDENT, transform_type="affine", target_shape=(6, 7)))
_ROIS = np.array([[0, 1.0, 2.0, 20.0, 25.0], [1, 0.0, 0.0, 31.0, 31.0],
                  [0, 10.0, 4.0, 14.0, 30.0]], np.float32)


#: case id -> (op name, arrays, attrs)
CASES = {
    "GridGenerator-affine-identity": ("GridGenerator", [_IDENT],
                                      dict(transform_type="affine",
                                           target_shape=(4, 5))),
    "GridGenerator-affine": ("GridGenerator", [_n(3, 6)],
                             dict(transform_type="affine",
                                  target_shape=(5, 7))),
    "GridGenerator-warp-zero": ("GridGenerator",
                                [np.zeros((1, 2, 4, 6), np.float32)],
                                dict(transform_type="warp")),
    "GridGenerator-warp": ("GridGenerator", [_n(2, 2, 5, 4)],
                           dict(transform_type="warp")),
    "BilinearSampler-identity": ("BilinearSampler",
                                 [_u(0, 1, 2, 3, 6, 7), _IDENT_GRID], {}),
    "BilinearSampler": ("BilinearSampler", [_n(2, 3, 6, 7),
                                            _u(-1.2, 1.2, 2, 2, 4, 5)], {}),
    "SpatialTransformer-shift": ("SpatialTransformer",
                                 [_SPOT, np.array([[1, 0, 0.5, 0, 1, 0]],
                                                  np.float32)],
                                 dict(target_shape=(5, 5))),
    "SpatialTransformer": ("SpatialTransformer",
                           [_n(2, 3, 8, 8), _IDENT + _n(2, 6) * 0.2],
                           dict(target_shape=(6, 5))),
    "Crop-center": ("Crop", [np.arange(36, dtype=np.float32).reshape(
        1, 1, 6, 6)], dict(h_w=(2, 2), center_crop=True)),
    "Crop-offset": ("Crop", [_n(2, 3, 7, 8)], dict(h_w=(3, 4),
                                                   offset=(2, 1))),
    "Crop-like": ("Crop", [_n(2, 3, 7, 8), _n(2, 1, 5, 5)],
                  dict(num_args=2, center_crop=True)),
    "Correlation-zero": ("Correlation", [_CORR, _CORR],
                         dict(kernel_size=1, max_displacement=0, stride1=1,
                              stride2=1, pad_size=0)),
    "Correlation-k3": ("Correlation", [_n(2, 3, 9, 8), _n(2, 3, 9, 8)],
                       dict(kernel_size=3, max_displacement=2, stride1=1,
                            stride2=1, pad_size=2)),
    "Correlation-strides": ("Correlation", [_n(1, 4, 10, 12),
                                            _n(1, 4, 10, 12)],
                            dict(kernel_size=1, max_displacement=4,
                                 stride1=2, stride2=2, pad_size=4)),
    "Correlation-absdiff": ("Correlation", [_n(1, 2, 6, 7), _n(1, 2, 6, 7)],
                            dict(kernel_size=3, max_displacement=1,
                                 pad_size=1, is_multiply=False)),
    "DeformableConvolution-zero-offset": (
        "_contrib_DeformableConvolution",
        [_u(0, 1, 2, 3, 8, 8), np.zeros((2, 18, 8, 8), np.float32),
         _u(0, 1, 4, 3, 3, 3)],
        dict(kernel=(3, 3), num_filter=4, pad=(1, 1), no_bias=True)),
    "Convolution-for-zero-offset": (
        "Convolution", [_u(0, 1, 2, 3, 8, 8), _u(0, 1, 4, 3, 3, 3), None],
        dict(kernel=(3, 3), num_filter=4, pad=(1, 1), no_bias=True)),
    "DeformableConvolution-fractional": (
        "_contrib_DeformableConvolution",
        [_FRAC, _FRAC_OFF, np.ones((1, 1, 1, 1), np.float32)],
        dict(kernel=(1, 1), num_filter=1, no_bias=True)),
    "DeformablePSROIPooling": ("_contrib_DeformablePSROIPooling",
                               [_n(2, 8, 8, 8), _ROIS, _n(3, 2, 2, 2)],
                               dict(spatial_scale=0.25, output_dim=2,
                                    group_size=2, pooled_size=2, part_size=2,
                                    sample_per_part=1, trans_std=0.1)),
    "DeformablePSROIPooling-no-trans": ("DeformablePSROIPooling",
                                        [_n(2, 3, 8, 8), _ROIS],
                                        dict(spatial_scale=0.25,
                                             output_dim=3, group_size=1,
                                             pooled_size=1,
                                             sample_per_part=2,
                                             no_trans=True)),
    "Proposal": ("_contrib_Proposal", [_RPN1[0], _RPN1[1],
                                       np.array([[64, 64, 1.0]], np.float32)],
                 dict(rpn_pre_nms_top_n=12, rpn_post_nms_top_n=5,
                      threshold=0.7, rpn_min_size=4, scales=(4, 8, 16),
                      ratios=(1.0,), feature_stride=16)),
    "MultiProposal-score": ("MultiProposal",
                            [_RPN2[0], _RPN2[1],
                             np.array([[96, 112, 1.0], [80, 100, 0.8]],
                                      np.float32)],
                            dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40,
                                 threshold=0.5, rpn_min_size=8,
                                 scales=(2, 4, 8), feature_stride=16,
                                 output_score=True)),
    "MultiProposal-moved": ("MultiProposal",
                            [_RPN2_MOVED[0], _RPN2_MOVED[1],
                             np.array([[96, 112, 1.0], [80, 100, 0.8]],
                                      np.float32)],
                            dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40,
                                 threshold=0.5, rpn_min_size=8,
                                 scales=(2, 4, 8), feature_stride=16,
                                 output_score=True)),
    "MultiProposal-sized": ("MultiProposal",
                            [_RPN2_SIZED[0], _RPN2_SIZED[1],
                             np.array([[96, 112, 1.0], [80, 100, 0.8]],
                                      np.float32)],
                            dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40,
                                 threshold=0.5, rpn_min_size=8,
                                 scales=(2, 4, 8), feature_stride=16,
                                 output_score=True)),
    "Proposal-ties": ("Proposal", [_RPN_TIES[0][:1], _RPN_TIES[1][:1],
                                   np.array([[96, 112, 1.0]], np.float32)],
                      dict(rpn_pre_nms_top_n=300, rpn_post_nms_top_n=60,
                           threshold=0.6, rpn_min_size=4, scales=(2, 4, 8),
                           output_score=True)),
    "Proposal-iou-loss": ("_contrib_Proposal",
                          [_RPN2[0][:1], _RPN2[1][:1] * 20,
                           np.array([[96, 112, 1.0]], np.float32)],
                          dict(rpn_pre_nms_top_n=100, rpn_post_nms_top_n=30,
                               scales=(2, 4, 8), iou_loss=True,
                               output_score=True)),
    "Proposal-few": ("_contrib_Proposal",
                     [_RPN1[0], _RPN1[1], np.array([[64, 64, 1.0]],
                                                   np.float32)],
                     dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=40,
                          threshold=0.3, rpn_min_size=30, scales=(2, 4, 8),
                          ratios=(1.0,), output_score=True)),
    "SyncBatchNorm": ("_contrib_SyncBatchNorm",
                      [_u(0, 1, 4, 3, 5, 5), np.ones(3, np.float32),
                       np.zeros(3, np.float32), np.zeros(3, np.float32),
                       np.ones(3, np.float32)],
                      dict(fix_gamma=False, ndev=4, key="sbn")),
    "BatchNorm-for-SyncBatchNorm": ("BatchNorm",
                                    [_u(0, 1, 4, 3, 5, 5),
                                     np.ones(3, np.float32),
                                     np.zeros(3, np.float32),
                                     np.zeros(3, np.float32),
                                     np.ones(3, np.float32)],
                                    dict(fix_gamma=False)),
    "SyncBatchNorm-gamma": ("SyncBatchNorm",
                            [_n(2, 4, 3, 3), _u(0.5, 1.5, 4), _n(4), _n(4),
                             _u(0.5, 1.5, 4)], dict(eps=1e-5)),
    "div_sqrt_dim": ("_contrib_div_sqrt_dim", [_n(2, 3, 16)], {}),
    "selfatt_qk": ("_contrib_interleaved_matmul_selfatt_qk",
                   [_u(0, 1, 6, 2, 2 * 4 * 3)], dict(heads=2)),
    "selfatt_valatt": ("_contrib_interleaved_matmul_selfatt_valatt",
                       [_u(0, 1, 6, 2, 2 * 4 * 3), _u(0, 1, 4, 6, 6)],
                       dict(heads=2)),
    "selfatt_qk-wide": ("_contrib_interleaved_matmul_selfatt_qk",
                        [_n(7, 3, 3 * 16 * 3)], dict(heads=3)),
    "selfatt_valatt-wide": ("_contrib_interleaved_matmul_selfatt_valatt",
                            [_n(7, 3, 3 * 16 * 3), _u(0, 1, 9, 7, 7)],
                            dict(heads=3)),
    "encdec_qk": ("_contrib_interleaved_matmul_encdec_qk",
                  [_u(0, 1, 3, 2, 8), _u(0, 1, 5, 2, 16)], dict(heads=2)),
    "encdec_valatt": ("_contrib_interleaved_matmul_encdec_valatt",
                      [_u(0, 1, 5, 2, 16), _u(0, 1, 4, 3, 5)],
                      dict(heads=2)),
    "fft": ("_contrib_fft", [_u(0, 1, 3, 8)], {}),
    "ifft": ("_contrib_ifft", [_n(3, 16)], {}),
    "fft-3d": ("_contrib_fft", [_n(2, 3, 10)], dict(compute_size=4)),
    "count_sketch": ("_contrib_count_sketch",
                     [np.array([[1.0, 2.0, 3.0]], np.float32),
                      np.array([[0, 1, 0]], np.float32),
                      np.array([[1, -1, 1]], np.float32)], dict(out_dim=2)),
    "count_sketch-batch": ("_contrib_count_sketch",
                           [_n(4, 12), _RNG.randint(0, 5, (1, 12)).astype(
                               np.float32),
                            np.sign(_n(1, 12))], dict(out_dim=5)),
    "boolean_mask": ("_contrib_boolean_mask",
                     [np.arange(12, dtype=np.float32).reshape(4, 3),
                      np.array([1, 0, 1, 0], np.int32)], {}),
    "boolean_mask-axis": ("boolean_mask", [_n(3, 5),
                                           np.array([0, 2, 0, 1, 1],
                                                    np.int32)],
                          dict(axis=1)),
    "index_copy": ("_contrib_index_copy",
                   [np.zeros((4, 2), np.float32),
                    np.array([1, 3], np.float32),
                    np.ones((2, 2), np.float32)], {}),
    "index_copy-grad": ("_contrib_index_copy",
                        [_n(5, 3), np.array([4, 0, 2], np.int64), _n(3, 3)],
                        {}),
    "index_array": ("_contrib_index_array", [np.zeros((2, 3))], {}),
    "index_array-axes": ("_contrib_index_array",
                         [np.zeros((2, 3, 4), np.float32)],
                         dict(axes=(2, 0))),
}

#: cases held equal, every output and gradient
EXACT = {"Crop-center", "Crop-offset", "Crop-like", "boolean_mask",
         "boolean_mask-axis", "index_copy", "index_copy-grad", "index_array",
         "index_array-axes", "count_sketch"}

#: ``Proposal`` cases, held by :func:`_check_proposal`
PROPOSALS = {c for c, (name, _, _) in CASES.items()
             if name in ("Proposal", "_contrib_Proposal", "MultiProposal")}

_REF = {}


def _reference(case):
    if not _REF:
        _REF.update(reference(jreg.OPS, CASES))
    return _REF[case]


def _box_tol(arrays, attrs):
    """One float32 ULP of the largest box side the decode's ``exp`` gives
    before clipping, plus one of the image's larger side (0 with
    ``iou_loss``, whose decode has no ``exp``)."""
    if attrs.get("iou_loss"):
        return 0.0
    _, bbox, info = arrays
    n, four_a, fh, fw = bbox.shape
    anchors = np.asarray(jcontrib._make_anchors(
        fh, fw, int(attrs.get("feature_stride", 16)),
        [float(s) for s in attrs.get("scales", (4, 8, 16, 32))],
        [float(r) for r in attrs.get("ratios", (0.5, 1, 2))]))
    side = np.max(anchors[:, 2:] - anchors[:, :2] + 1.0)
    sizes = bbox.reshape(n, four_a // 4, 4, fh, fw)[:, :, 2:]
    widest = np.float32(side * np.exp(np.clip(sizes.max(), -10, 10)))
    return float(np.spacing(widest) + np.spacing(np.float32(info[:, :2].max())))


def _check_proposal(case):
    """The picked scores and the rois' batch indices equal the
    reference's, the box coordinates within :func:`_box_tol`."""
    name, arrays, attrs = CASES[case]
    want, _ = _reference(case)
    got, grads = port(treg.OPS[name], arrays, attrs, 0)
    assert grads is None and len(got) == len(want), case
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, case
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0], err_msg=case)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=case)
    err = float(np.max(np.abs(got[0][:, 1:].astype(np.float64)
                              - want[0][:, 1:])))
    tol = _box_tol(arrays, attrs)
    assert err <= tol, "%s: boxes %g from the reference's, over %g" % (
        case, err, tol)
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    if case in PROPOSALS:
        _check_proposal(case)
        return
    check(case, CASES, _reference(case), jreg.OPS, treg.OPS,
          exact=case in EXACT)


def test_proposal_box_tolerance_is_used():
    """``MultiProposal-sized``'s size deltas meet values whose float32
    ``exp`` XLA's CPU backend rounds off by one from the correctly
    rounded one, and its rois differ from the reference's within the
    tolerance (they are not bit-equal)."""
    got, want = _check_proposal("MultiProposal-sized")
    _, bbox, _ = CASES["MultiProposal-sized"][1]
    sizes = bbox.reshape(2, 9, 4, 6, 7)[:, :, 2:].ravel()
    xla = np.asarray(jax.jit(jnp.exp)(sizes))
    assert np.any(xla != np.exp(sizes.astype(np.float64)).astype(np.float32))
    assert not np.array_equal(got[0], want[0])


def test_reference_cases_hold_their_identities():
    """The reference test's own identities, on the port: the identity grid
    samples the data back, a shift moves the peak left, zero offsets give
    the convolution, a half-pixel offset interpolates, zero displacement
    is the channel mean of the product, SyncBatchNorm is BatchNorm, the
    FFT matches numpy's and ifft(fft(x)) is x * d."""
    def run(name, *arrays, **attrs):
        out = treg.OPS[name].fn(*[None if a is None else torch.tensor(a)
                                  for a in arrays], **attrs)
        return [o.detach().numpy() for o in out] \
            if isinstance(out, tuple) else out.detach().numpy()

    grid = run("GridGenerator", _IDENT, transform_type="affine",
               target_shape=(4, 5))
    np.testing.assert_allclose(grid[0, 0, 0], np.linspace(-1, 1, 5),
                               atol=1e-6)
    data = _u(0, 1, 2, 3, 6, 7)
    grid = run("GridGenerator", _IDENT, transform_type="affine",
               target_shape=(6, 7))
    np.testing.assert_allclose(run("BilinearSampler", data, grid), data,
                               rtol=1e-4, atol=1e-5)
    flow = run("GridGenerator", np.zeros((2, 2, 6, 7), np.float32),
               transform_type="warp")
    np.testing.assert_allclose(run("BilinearSampler", data, flow), data,
                               rtol=1e-4, atol=1e-5)
    out = run("SpatialTransformer", _SPOT, np.array([[1, 0, 0.5, 0, 1, 0]],
                                                    np.float32),
              target_shape=(5, 5))
    assert out[0, 0, 2, 1] == pytest.approx(1.0, abs=1e-4)
    x, w = _u(0, 1, 2, 3, 8, 8), _u(0, 1, 4, 3, 3, 3)
    got = run("_contrib_DeformableConvolution", x,
              np.zeros((2, 18, 8, 8), np.float32), w, kernel=(3, 3),
              num_filter=4, pad=(1, 1), no_bias=True)
    conv = run("Convolution", x, w, None, kernel=(3, 3), num_filter=4,
               pad=(1, 1), no_bias=True)
    np.testing.assert_allclose(got, conv, rtol=1e-4, atol=1e-5)
    got = run("_contrib_DeformableConvolution", _FRAC, _FRAC_OFF,
              np.ones((1, 1, 1, 1), np.float32), kernel=(1, 1),
              num_filter=1, no_bias=True)
    assert got[0, 0, 1, 1] == pytest.approx(2.0, abs=1e-5)
    out = run("Correlation", _CORR, _CORR, kernel_size=1,
              max_displacement=0)
    np.testing.assert_allclose(out[0, 0], (_CORR * _CORR).mean(axis=1)[0],
                               rtol=1e-5)
    args = CASES["SyncBatchNorm"][1]
    np.testing.assert_allclose(run("_contrib_SyncBatchNorm", *args,
                                   fix_gamma=False, ndev=4, key="sbn"),
                               run("BatchNorm", *args, fix_gamma=False),
                               rtol=1e-6)
    x = _u(0, 1, 3, 8)
    spec = run("_contrib_fft", x)
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(spec[:, 0::2], ref.real, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(spec[:, 1::2], ref.imag, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(run("_contrib_ifft", spec), x * 8, rtol=1e-4,
                               atol=1e-4)


def test_proposal_boxes_are_valid():
    """The reference test's checks of the rois: batch index 0, inside the
    64 x 64 image, x2 >= x1."""
    rois = treg.OPS["_contrib_Proposal"].fn(
        torch.tensor(_RPN1[0]), torch.tensor(_RPN1[1]),
        torch.tensor([[64, 64, 1.0]]), rpn_pre_nms_top_n=12,
        rpn_post_nms_top_n=5, threshold=0.7, rpn_min_size=4,
        scales=(4, 8, 16), ratios=(1.0,), feature_stride=16).numpy()
    assert rois.shape == (5, 5)
    assert (rois[:, 0] == 0).all()
    assert (rois[:, 1] >= 0).all() and (rois[:, 3] <= 63).all()
    assert (rois[:, 2] >= 0).all() and (rois[:, 4] <= 63).all()
    assert (rois[:, 3] >= rois[:, 1]).all()


def test_sync_batch_norm_updates_running_stats_as_batch_norm():
    """``SyncBatchNorm`` keeps ``BatchNorm``'s running-stat rule
    (``aux_update``, inputs 3 and 4), as the reference's."""
    jop, top = jreg.OPS["_contrib_SyncBatchNorm"], \
        treg.OPS["_contrib_SyncBatchNorm"]
    assert top.mutate_idx == (3, 4) == tuple(jop.mutate_idx)
    assert top.aux_update is treg.OPS["BatchNorm"].aux_update
    args = [torch.tensor(a) for a in CASES["SyncBatchNorm-gamma"][1]]
    new = top.aux_update(args, [None], momentum=0.9)
    want = treg.OPS["BatchNorm"].aux_update(args, [None], momentum=0.9)
    for k in (3, 4):
        assert torch.equal(new[k], want[k])


def test_boolean_mask_refuses_shape_inference():
    """``boolean_mask``'s shape follows its data: ``Op.infer`` refuses it,
    as the reference marks it ``no_trace``."""
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(TypeError, match="data-dependent"):
        treg.OPS["_contrib_boolean_mask"].infer([meta, meta])


def test_proposal_infers_its_shapes():
    """On ``meta`` tensors ``Proposal`` answers (N * post_n, 5) rois (and
    (N * post_n, 1) scores) without running its loop."""
    metas = [torch.empty(s, device="meta") for s in
             ((2, 18, 38, 63), (2, 36, 38, 63), (2, 3))]
    rois, scores = treg.OPS["MultiProposal"].infer(
        metas, rpn_post_nms_top_n=300, output_score=True)
    assert tuple(rois.shape) == (600, 5) and tuple(scores.shape) == (600, 1)


def test_contrib_namespaces_resolve_the_new_names():
    """``mx.nd.contrib.<name>`` and ``mx.sym.contrib.<name>`` resolve the
    new ``_contrib_`` ops, as the reference's namespaces do."""
    cpu = mx.cpu()
    x = mx.nd.array(_n(2, 3, 16), ctx=cpu)
    np.testing.assert_array_equal(
        mx.nd.contrib.div_sqrt_dim(x).asnumpy(),
        mx.nd._contrib_div_sqrt_dim(x).asnumpy())
    s = mx.sym.contrib.interleaved_matmul_selfatt_qk(mx.sym.var("qkv"),
                                                     heads=2)
    _, out, _ = s.infer_shape(qkv=(6, 2, 24))
    assert out == [(4, 6, 6)]
