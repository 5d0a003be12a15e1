"""The port's ``gluon.data`` against the JAX package's, on the CPU.

- Samplers under ``np.random.seed``: the same indices.
- Datasets: the combinators, ``RecordFileDataset`` and
  ``ImageRecordDataset`` on a shard the reference's ``recordio`` wrote,
  and the vision datasets from files written into ``tmp_path`` (MNIST's
  idx files plain and gzipped, CIFAR's binary batches, an image folder):
  the same samples.
- ``DataLoader`` at 0 workers and at thread workers, shuffled under the
  same seed: the same batches in the same order, with the same dtypes;
  one ``thread_pool=False`` case with 2 spawned workers, none of which
  initializes CUDA.
- Each transform under the same ``random.seed``/``np.random.seed``:
  uint8 outputs within 1 code of the reference's (the count of codes
  that differ is printed), float outputs within 1e-4 of the [0, 255]
  scale (2.55e-2; 1e-4 for [0, 1] outputs), dtypes equal.
"""
import gzip
import os
import random
import struct

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import recordio as jrecordio
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jT

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as tT

CPU = tmx.cpu()


def _np(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return np.asarray(v)


def _same_tree(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
        return
    x, y = _np(a), _np(b)
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- samplers
SAMPLERS = [
    ("sequential", lambda m: m.SequentialSampler(7, start=3)),
    ("random", lambda m: m.RandomSampler(11)),
    ("split", lambda m: m.SplitSampler(23, num_parts=3, part_index=2)),
    ("batch_keep", lambda m: m.BatchSampler(m.RandomSampler(10), 3, "keep")),
    ("batch_discard",
     lambda m: m.BatchSampler(m.SequentialSampler(10), 3, "discard")),
    ("batch_rollover",
     lambda m: m.BatchSampler(m.RandomSampler(10), 4, "rollover")),
    ("filter",
     lambda m: m.FilterSampler(lambda x: x % 3 == 1,
                               m.SimpleDataset(list(range(20))))),
]


@pytest.mark.parametrize("make", [s[1] for s in SAMPLERS],
                         ids=[s[0] for s in SAMPLERS])
def test_samplers_match_reference(make):
    out = []
    for mod in (jdata, tdata):
        np.random.seed(5)
        s = make(mod)
        passes = [list(s) for _ in range(3)]
        out.append((passes, len(s)))
    assert out[0] == out[1]


# ----------------------------------------------------------------- datasets
def test_dataset_combinators_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 100, (13, 3)).astype(np.int32)
    y = np.arange(13, dtype=np.float32)
    got = []
    for mod in (jdata, tdata):
        ds = mod.ArrayDataset(x, list(y))
        views = [
            ds,
            ds.transform(lambda a, b: (a * 2, b + 1)),
            ds.transform_first(lambda a: a[::-1]),
            ds.filter(lambda s: s[1] % 2 == 0),
            ds.shard(4, 1), ds.shard(4, 3),
            ds.take(5),
            ds.sample(mod.SequentialSampler(4, start=6)),
            ds.transform(lambda a, b: b * 3, lazy=False),
            mod.SimpleDataset([1, 2, 3]),
        ]
        got.append([[v[i] for i in range(len(v))] for v in views])
    for a, b in zip(*got):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)


def _write_reference_shard(prefix, n=9, side=12):
    rng = np.random.RandomState(3)
    rec = jrecordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    imgs = []
    for i in range(n):
        img = rng.randint(0, 255, (side, side + 3, 3), dtype=np.uint8)
        imgs.append(img)
        rec.write_idx(i, jrecordio.pack_img(
            jrecordio.IRHeader(0, float(i % 4), i, 0), img, img_fmt=".npy"))
    rec.close()
    return imgs


def test_record_datasets_read_reference_shard(tmp_path):
    prefix = str(tmp_path / "shard")
    imgs = _write_reference_shard(prefix)
    raw_j = jdata.RecordFileDataset(prefix + ".rec")
    raw_t = tdata.RecordFileDataset(prefix + ".rec")
    assert len(raw_t) == len(raw_j) == len(imgs)
    assert [raw_t[i] for i in range(len(raw_t))] == \
        [raw_j[i] for i in range(len(raw_j))]
    img_j = jdata.vision.ImageRecordDataset(prefix + ".rec")
    img_t = tdata.vision.ImageRecordDataset(prefix + ".rec")
    for i in range(len(imgs)):
        (a, la), (b, lb) = img_j[i], img_t[i]
        assert b.context == CPU and b.dtype == np.uint8
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
        np.testing.assert_array_equal(b.asnumpy(), imgs[i])
        assert lb == la


def _write_mnist(root, n, gz):
    root.mkdir()
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 255, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(str(root / ("train-images-idx3-ubyte" + suffix)), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with opener(str(root / ("train-labels-idx1-ubyte" + suffix)), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, files, label_bytes, n=6):
    root.mkdir()
    rng = np.random.RandomState(2)
    for f in files:
        rows = rng.randint(0, 255, (n, label_bytes + 3072)).astype(np.uint8)
        rows[:, :label_bytes] %= 10
        (root / f).write_bytes(rows.tobytes())


def _same_datasets(dj, dt):
    assert len(dt) == len(dj)
    for i in range(len(dj)):
        (a, la), (b, lb) = dj[i], dt[i]
        assert b.context == CPU
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
        assert np.asarray(lb).dtype == np.asarray(la).dtype and lb == la


def test_vision_datasets_match_reference(tmp_path):
    _write_mnist(tmp_path / "mnist", 5, gz=False)
    _write_mnist(tmp_path / "fashion", 4, gz=True)
    _write_cifar(tmp_path / "c10", ["data_batch_%d.bin" % i
                                    for i in range(1, 6)], 1)
    _write_cifar(tmp_path / "c100", ["train.bin"], 2)
    for cls, kw in (("MNIST", {"root": str(tmp_path / "mnist")}),
                    ("FashionMNIST", {"root": str(tmp_path / "fashion")}),
                    ("CIFAR10", {"root": str(tmp_path / "c10")}),
                    ("CIFAR100", {"root": str(tmp_path / "c100")}),
                    ("CIFAR100", {"root": str(tmp_path / "c100"),
                                  "fine_label": True})):
        _same_datasets(getattr(jdata.vision, cls)(**kw),
                       getattr(tdata.vision, cls)(**kw))
    folder = tmp_path / "folders"
    rng = np.random.RandomState(4)
    for cls in ("cat", "dog", "emu"):
        (folder / cls).mkdir(parents=True)
        for k in range(2):
            np.save(str(folder / cls / ("%d.npy" % k)),
                    rng.randint(0, 255, (5, 6, 3)).astype(np.uint8))
    (folder / "notes.txt").write_text("not a class")
    fj = jdata.vision.ImageFolderDataset(str(folder))
    ft = tdata.vision.ImageFolderDataset(str(folder))
    assert ft.synsets == fj.synsets == ["cat", "dog", "emu"]
    _same_datasets(fj, ft)
    with pytest.raises(FileNotFoundError):
        tdata.vision.MNIST(root=str(tmp_path / "absent"))


def test_mxnet_home_reroots_default(tmp_path, monkeypatch):
    _write_mnist(tmp_path / "datasets", 3, gz=True)
    os.rename(str(tmp_path / "datasets"), str(tmp_path / "mnist"))
    (tmp_path / "datasets").mkdir()
    os.rename(str(tmp_path / "mnist"), str(tmp_path / "datasets" / "mnist"))
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    _same_datasets(jdata.vision.MNIST(), tdata.vision.MNIST())


# ---------------------------------------------------------------- DataLoader
LOADERS = [
    ("0-workers", dict(batch_size=4, shuffle=True)),
    ("0-workers-discard", dict(batch_size=4, last_batch="discard")),
    ("0-workers-rollover", dict(batch_size=4, shuffle=True,
                                last_batch="rollover")),
    ("threads", dict(batch_size=3, shuffle=True, num_workers=2)),
    ("threads-prefetch", dict(batch_size=5, num_workers=3, prefetch=1)),
]


def _loader_data():
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (18, 2, 3)).astype(np.float32)
    y = rng.randint(0, 5, 18).astype(np.int32)
    return x, y


@pytest.mark.parametrize("kw", [c[1] for c in LOADERS],
                         ids=[c[0] for c in LOADERS])
def test_dataloader_matches_reference(kw):
    x, y = _loader_data()
    out = []
    for mod, extra in ((jdata, {}), (tdata, {"device": "cpu"})):
        np.random.seed(11)
        ds = mod.ArrayDataset(x, y).transform_first(lambda a: a * 2)
        loader = mod.DataLoader(ds, **kw, **extra)
        out.append([list(b) for _ in range(2) for b in loader])
        assert len(loader) == len(out[-1]) // 2 or kw.get(
            "last_batch") == "rollover"
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert all(t.context == CPU for t in b)
        _same_tree(a, b)


def test_dataloader_record_images_thread_workers(tmp_path):
    prefix = str(tmp_path / "shard")
    _write_reference_shard(prefix, n=10)
    aug = [lambda m: m.Resize((8, 6)), lambda m: m.ToTensor()]
    np.random.seed(2)
    want = [list(b) for b in jdata.DataLoader(
        jdata.vision.ImageRecordDataset(prefix + ".rec").transform_first(
            jT.Compose([f(jT) for f in aug])),
        batch_size=4, shuffle=True)]
    np.random.seed(2)
    got = [list(b) for b in tdata.DataLoader(
        tdata.vision.ImageRecordDataset(prefix + ".rec").transform_first(
            tT.Compose([f(tT) for f in aug])),
        batch_size=4, shuffle=True, num_workers=3, device="cpu")]
    assert len(got) == len(want) == 3
    for (a, la), (b, lb) in zip(want, got):
        assert b.shape == a.shape and b.dtype == a.dtype == np.float32
        # the uint8 resize is held within 1 code, ToTensor scales it
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=0,
                                   atol=1 / 255 + 1e-6)
        _same_tree(la, lb)


def test_dataloader_spawned_workers(tmp_path):
    """``thread_pool=False``: 2 spawned processes give the thread
    loader's batches, in order, and none initializes CUDA."""
    prefix = str(tmp_path / "shard")
    _write_reference_shard(prefix, n=8)
    ds = tdata.vision.ImageRecordDataset(prefix + ".rec").transform_first(
        tT.Compose([tT.Resize((6, 5)), tT.ToTensor()]))
    out = []
    for kw in (dict(num_workers=2), dict(num_workers=2, thread_pool=False)):
        loader = tdata.DataLoader(ds, batch_size=3, device="cpu", **kw)
        out.append([list(b) for b in loader])
        cuda = loader.worker_cuda_initialized()
        del loader
    assert len(out[1]) == 3
    assert len(cuda) >= 1 and not any(cuda.values())
    for a, b in zip(*out):
        _same_tree(a, b)


# ---------------------------------------------------------------- transforms
def _img(dtype, shape=(37, 53, 3), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 255, shape).astype(np.float32)


TRANSFORMS = [
    ("resize-down-bilinear", lambda m: m.Resize((24, 24))),
    ("resize-up-bilinear", lambda m: m.Resize((80, 64))),
    ("resize-mixed", lambda m: m.Resize((70, 20))),
    ("resize-down-nearest", lambda m: m.Resize((24, 17), interpolation=0)),
    ("resize-up-nearest", lambda m: m.Resize((80, 64), interpolation=0)),
    ("resize-keep-ratio", lambda m: m.Resize(20, keep_ratio=True)),
    ("center-crop", lambda m: m.CenterCrop(21)),
    ("center-crop-resize", lambda m: m.CenterCrop((60, 30))),
    ("crop-resize", lambda m: m.CropResize(3, 4, 20, 25, size=(16, 12))),
    ("crop", lambda m: m.CropResize(5, 2, 11, 9)),
    ("random-resized-crop", lambda m: m.RandomResizedCrop(24)),
    ("random-resized-crop-narrow",
     lambda m: m.RandomResizedCrop((20, 16), scale=(0.9, 1.0),
                                   ratio=(3.0, 4.0))),
    ("flip-lr", lambda m: m.RandomFlipLeftRight()),
    ("flip-tb", lambda m: m.RandomFlipTopBottom()),
    ("brightness", lambda m: m.RandomBrightness(0.4)),
    ("contrast", lambda m: m.RandomContrast(0.4)),
    ("saturation", lambda m: m.RandomSaturation(0.4)),
    ("hue", lambda m: m.RandomHue(0.4)),
    ("color-jitter", lambda m: m.RandomColorJitter(0.3, 0.3, 0.3, 0.2)),
    ("lighting", lambda m: m.RandomLighting(0.5)),
    ("cast", lambda m: m.Cast("float16")),
    ("to-tensor", lambda m: m.ToTensor()),
    ("to-tensor-normalize",
     lambda m: m.Compose([m.ToTensor(),
                          m.Normalize((0.485, 0.456, 0.406),
                                      (0.229, 0.224, 0.225))])),
    ("normalize-scalar", lambda m: m.Normalize(10.0, 3.0)),
    ("pipeline",
     lambda m: m.Compose([m.RandomResizedCrop(16), m.RandomFlipLeftRight(),
                          m.RandomColorJitter(0.2, 0.2, 0.2),
                          m.RandomLighting(0.1)])),
]


def _run_transform(make, mod, x, seed):
    t = make(mod)
    outs = []
    random.seed(seed)
    np.random.seed(seed)
    for _ in range(4):
        arr = jmx.nd.array(x, dtype=x.dtype) if mod is jT \
            else tmx.nd.array(x, ctx=CPU)
        outs.append(t(arr).asnumpy())
    return outs


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("make", [t[1] for t in TRANSFORMS],
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_reference(make, dtype, request):
    # outputs on [0, 1] (ToTensor, Normalize after it) are held to 1e-4,
    # the others to 1e-4 of the [0, 255] scale
    scale = 1.0 if "to-tensor" in request.node.callspec.id else 255.0
    atol = 1e-4 * scale
    if request.node.callspec.id == "pipeline-uint8":
        # the crop's uint8 resize may differ by 1 code, which the three
        # jitters (factors up to 1.2 each) carry into the float output
        atol += 1.2 ** 3
    x = _img(dtype)
    want = _run_transform(make, jT, x, 3)
    got = _run_transform(make, tT, x, 3)
    differing = 0
    for a, b in zip(want, got):
        assert b.dtype == a.dtype and b.shape == a.shape
        if a.dtype == np.uint8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1
            differing += int((diff > 0).sum())
        else:
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=0,
                                       atol=atol)
    print("uint8 codes that differ: %d of %d" % (
        differing, sum(a.size for a in want)))


def test_crop_window_out_of_range_raises():
    with pytest.raises(ValueError):
        tT.CropResize(50, 0, 10, 10)(tmx.nd.array(_img("uint8"), ctx=CPU))


def test_nhwc_batch_transforms_match_reference():
    x = _img("uint8", (2, 20, 24, 3), seed=5)
    for make in (lambda m: m.Resize((10, 12)), lambda m: m.ToTensor(),
                 lambda m: m.CenterCrop(8),
                 lambda m: m.Compose([m.ToTensor(),
                                      m.Normalize((0.1, 0.2, 0.3),
                                                  (0.5, 0.6, 0.7))])):
        a = make(jT)(jmx.nd.array(x, dtype="uint8")).asnumpy()
        b = make(tT)(tmx.nd.array(x, ctx=CPU)).asnumpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=0,
                                   atol=1 if a.dtype == np.uint8 else 1e-4)
