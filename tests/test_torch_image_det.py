"""``mx.image`` (``ImageIter``, the augmenters, ``ImageDetIter``) and
``mx.io.ImageDetRecordIter`` of the port against the JAX package's, on
the CPU.

Both packages read the same ``.rec``/``.idx`` files (PNG images of two
sizes, detection labels of 1-4 objects in im2rec's packing ``[2, 5,
(cls, x1, y1, x2, y2) * n]``) and the same image list.  Every batch's
data, labels and pad must agree bit for bit.  The augmenters draw from
Python's ``random`` (and numpy's global generator for the lighting
noise), which both packages share: each side runs after the same seeds.
"""
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import recordio

SHAPE = (3, 16, 16)


def _det_label(rng, n_obj):
    objs = []
    for _ in range(n_obj):
        x0, y0 = rng.rand(2) * 0.5
        w, h = rng.rand(2) * 0.4 + 0.05
        objs += [rng.randint(0, 3), x0, y0, x0 + w, y0 + h]
    return np.array([2, 5] + objs, np.float32)


@pytest.fixture(scope="module")
def det_files(tmp_path_factory):
    """A detection .rec/.idx of 7 records and an image list of 5 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("det")
    rng = np.random.RandomState(0)
    prefix = str(root / "det")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    labels = []
    for i in range(7):
        img = rng.randint(0, 255, (20 + 4 * (i % 2), 24, 3), dtype=np.uint8)
        labels.append(_det_label(rng, 1 + i % 4))
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, labels[-1], i, 0), img, img_fmt=".png"))
    rec.close()
    imglist = []
    for i in range(5):
        p = str(root / ("d%d.png" % i))
        Image.fromarray(rng.randint(0, 255, (18, 22, 3), dtype=np.uint8)
                        ).save(p)
        imglist.append((_det_label(rng, 1 + i % 3)[2:].tolist(), p))
    return prefix, labels, imglist


def _drain(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b) > 0
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert da.dtype == db.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


@pytest.mark.parametrize("source", ["rec", "idx", "imglist"])
def test_image_det_iter_matches_reference(det_files, source):
    prefix, _, imglist = det_files

    def run(mx, **kw):
        augs = mx.image.CreateDetAugmenter(SHAPE, rand_mirror=True,
                                           mean=True, std=True)
        if source == "imglist":
            src = dict(imglist=imglist, path_root="")
        else:
            src = dict(path_imgrec=prefix + ".rec")
            if source == "idx":
                src.update(path_imgidx=prefix + ".idx", shuffle=True)
        it = mx.image.ImageDetIter(batch_size=3, data_shape=SHAPE,
                                   aug_list=augs, **src, **kw)
        out = _drain(it)
        assert it.provide_label[0].shape == (3, it.max_objects, 5)
        it.reset()
        return out + _drain(it)

    want = _seeded(11, lambda: run(jmx))
    got = _seeded(11, lambda: run(tmx, ctx=tmx.cpu()))
    _same(got, want)
    labels = np.concatenate([g[1] for g in got])
    assert (labels[..., 0] == -1).any()       # padded object rows
    assert got[-1][2] > 0                     # a padded last batch


def test_image_iter_with_every_augmenter_matches_reference(det_files):
    prefix, _, _ = det_files

    def run(mx, **kw):
        augs = mx.image.CreateAugmenter(
            SHAPE, resize=20, rand_crop=True, rand_mirror=True, mean=True,
            std=True, brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1,
            pca_noise=0.1, rand_gray=0.3)
        augs.insert(1, mx.image.RandomSizedCropAug((20, 20), (0.3, 1.0),
                                                   (0.75, 1.33)))
        it = mx.image.ImageIter(batch_size=4, data_shape=SHAPE,
                                path_imgrec=prefix + ".rec",
                                path_imgidx=prefix + ".idx", label_width=3,
                                shuffle=True, aug_list=augs, **kw)
        return _drain(it)

    _same(_seeded(5, lambda: run(tmx, ctx=tmx.cpu())),
          _seeded(5, lambda: run(jmx)))


@pytest.mark.parametrize("pad_width", [0, 24])
def test_image_det_record_iter_matches_reference(det_files, pad_width):
    prefix, labels, _ = det_files

    def run(mx, **kw):
        it = mx.io.ImageDetRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=SHAPE, batch_size=3, label_pad_width=pad_width,
            mean_r=120.0, std_g=50.0, shuffle=True, seed=3, **kw)
        first = _drain(it)
        it.reset()
        second = _drain(it)
        it.close()
        return first + second

    got = run(tmx, ctx=tmx.cpu())
    _same(got, run(jmx))
    width = pad_width or max(len(lab) for lab in labels)
    lab = np.concatenate([g[1] for g in got])
    assert lab.shape[1] == width
    assert (lab == -1).any()                  # -1 pads the short labels


def test_image_det_record_iter_refusals(det_files):
    prefix, labels, _ = det_files
    it = tmx.io.ImageDetRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=SHAPE, batch_size=2, label_pad_width=len(labels[0]),
        ctx=tmx.cpu())
    with pytest.raises(Exception, match="label_pad_width"):
        for _ in it:
            pass
    it.close()
    with pytest.raises(ValueError, match="crop or mirror"):
        tmx.io.ImageDetRecordIter(path_imgrec=prefix + ".rec",
                                  data_shape=SHAPE, batch_size=2,
                                  rand_mirror=True, ctx=tmx.cpu())
