"""The port's data iterators against the JAX package's (``io/io.py``,
``io/record_iter.py``), on the CPU (``ctx=cpu()``).

The same arrays and seeds must give bit-identical batches (data, label,
pad): ``NDArrayIter`` with a seeded shuffle under each
``last_batch_handle``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
and ``ImageRecordIter``/``ImageRecordUInt8Iter`` over a 40-record shard
of 32x40 px PNG images (random crop and mirror, mean/std, resize, two
shards, with and without ``round_batch``), over two epochs.  A
mid-epoch ``state_dict()`` of either package's iterator, through JSON,
loads into the other's and gives the same next batches.  Without a card,
``ctx=None`` raises.  The idx (MNIST) file reader parses alike.
Everything is exact.
"""
import json

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import recordio as jrec

from incubator_mxnet_tpu_torch import cpu
from incubator_mxnet_tpu_torch import io as tio

CPU = cpu()


def _np(batch):
    return ([d.asnumpy() for d in batch.data],
            [l.asnumpy() for l in (batch.label or [])], batch.pad)


def _same(tb, jb):
    (td, tl, tp), (jd, jl, jp) = _np(tb), _np(jb)
    assert tp == jp
    assert len(td) == len(jd) and len(tl) == len(jl)
    for t, j in zip(td + tl, jd + jl):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append(list(it))
        it.reset()
    return out


def _same_epochs(t_it, j_it, n=2):
    tb, jb = _epochs(t_it, n), _epochs(j_it, n)
    assert [len(e) for e in tb] == [len(e) for e in jb]
    assert sum(len(e) for e in tb) > 0
    for te, je in zip(tb, jb):
        for t, j in zip(te, je):
            _same(t, j)


def _arrays():
    rng = np.random.RandomState(3)
    return (rng.normal(size=(23, 3, 4)).astype(np.float32),
            rng.randint(0, 5, size=23).astype(np.float32))


def _pair(make_t, make_j, seed):
    np.random.seed(seed)
    t = make_t()
    np.random.seed(seed)
    return t, make_j()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches(shuffle, handle):
    x, y = _arrays()
    kw = dict(batch_size=5, shuffle=shuffle, last_batch_handle=handle)
    t, j = _pair(lambda: tio.NDArrayIter(x, y, ctx=CPU, **kw),
                 lambda: jio.NDArrayIter(x, y, **kw), seed=11)
    _same_epochs(t, j, n=3)


def test_ndarray_iter_dict_inputs_match():
    x, y = _arrays()
    data = {"a": x, "b": x[:, :1] * 2}
    t = tio.NDArrayIter(data, {"lab": y}, batch_size=4, ctx=CPU)
    j = jio.NDArrayIter(data, {"lab": y}, batch_size=4)
    assert [d.name for d in t.provide_data] == \
        [d.name for d in j.provide_data]
    _same_epochs(t, j)


def test_resize_and_prefetching_iters_match():
    x, y = _arrays()
    t, j = _pair(lambda: tio.ResizeIter(tio.NDArrayIter(
        x, y, batch_size=4, shuffle=True, ctx=CPU), 9),
        lambda: jio.ResizeIter(jio.NDArrayIter(x, y, batch_size=4,
                                               shuffle=True), 9), seed=5)
    _same_epochs(t, j)
    t = tio.PrefetchingIter(tio.NDArrayIter(x, y, batch_size=6, ctx=CPU))
    j = jio.PrefetchingIter(jio.NDArrayIter(x, y, batch_size=6))
    _same_epochs(t, j)
    t.close()
    j.close()


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches(tmp_path, round_batch):
    x, y = _arrays()
    np.savetxt(tmp_path / "d.csv", x.reshape(23, -1), delimiter=",")
    np.savetxt(tmp_path / "l.csv", y, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(3, 4),
              label_csv=str(tmp_path / "l.csv"), batch_size=5,
              round_batch=round_batch)
    _same_epochs(tio.CSVIter(ctx=CPU, **kw), jio.CSVIter(**kw))


def _shard(tmp_path, n=40, h=32, w=40, fmt=".png"):
    prefix = str(tmp_path / "shard")
    rec = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        rec.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 10), i, 0),
                                       img, img_fmt=fmt))
    rec.close()
    return prefix


RECORD_CASES = {
    "crop_mirror_norm": dict(data_shape=(3, 24, 24), batch_size=8,
                             shuffle=True, rand_crop=True, rand_mirror=True,
                             mean_r=120.0, mean_g=110.0, mean_b=100.0,
                             std_r=50.0, std_g=60.0, std_b=70.0, seed=3),
    "resize": dict(data_shape=(3, 32, 32), batch_size=6, resize=36,
                   rand_crop=True, shuffle=True),
    "two_parts": dict(data_shape=(3, 32, 32), batch_size=7, num_parts=2,
                      part_index=1, shuffle=True, rand_mirror=True),
    "no_round_batch": dict(data_shape=(3, 28, 28), batch_size=12,
                           round_batch=False, shuffle=True),
    "no_index": dict(data_shape=(3, 32, 40), batch_size=16,
                     rand_mirror=True, path_imgidx=None),
}


def _record_pair(prefix, uint8, kw):
    kw = dict(kw)
    kw.setdefault("path_imgidx", prefix + ".idx")
    kw.update(path_imgrec=prefix + ".rec", preprocess_threads=2,
              prefetch_buffer=2)
    if uint8:
        kw = {k: v for k, v in kw.items()
              if not k.startswith(("mean_", "std_"))}
        return (tio.ImageRecordUInt8Iter(ctx=CPU, **kw),
                jio.ImageRecordUInt8Iter(**kw))
    return tio.ImageRecordIter(ctx=CPU, **kw), jio.ImageRecordIter(**kw)


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_iters_match(tmp_path, case, uint8):
    t, j = _record_pair(_shard(tmp_path), uint8, RECORD_CASES[case])
    try:
        _same_epochs(t, j)
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("src", ["jax", "port"])
@pytest.mark.parametrize("kind", ["ndarray", "record"])
def test_mid_epoch_state_crosses_packages(tmp_path, kind, src):
    """``state_dict()`` after 3 batches (for the record iterator, its
    whole first epoch), through JSON, into the other package's fresh
    iterator built with another seed: the next 4 batches, across the
    epoch boundary, equal the source's own."""
    if kind == "ndarray":
        x, y = _arrays()
        kw = dict(batch_size=4, shuffle=True, last_batch_handle="roll_over")
        t, j = _pair(lambda: tio.NDArrayIter(x, y, ctx=CPU, **kw),
                     lambda: jio.NDArrayIter(x, y, **kw), seed=2)
        t2, j2 = _pair(lambda: tio.NDArrayIter(x, y, ctx=CPU, **kw),
                       lambda: jio.NDArrayIter(x, y, **kw), seed=99)
    else:
        prefix = _shard(tmp_path)
        kw = dict(RECORD_CASES["crop_mirror_norm"], batch_size=16)
        t, j = _record_pair(prefix, True, kw)
        t2, j2 = _record_pair(prefix, True, dict(kw, seed=7))
    a, b = (j, t2) if src == "jax" else (t, j2)

    def take(it, n):
        out = []
        for _ in range(n):
            try:
                out.append(it.next())
            except StopIteration:
                it.reset()
                out.append(it.next())
        return out

    take(a, 3)
    b.load_state_dict(json.loads(json.dumps(a.state_dict())))
    for x_b, y_b in zip(take(a, 4), take(b, 4)):
        _same(x_b, y_b)
    for it in (t, j, t2, j2):
        getattr(it, "close", lambda: None)()


def test_state_of_another_iterator_is_refused(tmp_path):
    x, y = _arrays()
    it = tio.NDArrayIter(x, y, batch_size=4, ctx=CPU)
    with pytest.raises(ValueError, match="cannot load into NDArrayIter"):
        it.load_state_dict({"iter": "ImageRecordIter"})
    with pytest.raises(ValueError, match="batch_size=8"):
        it.load_state_dict(dict(it.state_dict(), batch_size=8))


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_iterators_refuse_cpu_without_asking(tmp_path, monkeypatch):
    prefix = _shard(tmp_path, n=4)
    x, y = _arrays()
    _no_card(monkeypatch)
    for build in (lambda: tio.NDArrayIter(x, y),
                  lambda: tio.ImageRecordUInt8Iter(
                      path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
                      batch_size=2),
                  lambda: tio.ImageRecordIter(
                      path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
                      batch_size=2, ctx="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_uint8_iter_refuses_normalization(tmp_path):
    prefix = _shard(tmp_path, n=4)
    with pytest.raises(ValueError, match="emits raw bytes"):
        tio.ImageRecordUInt8Iter(path_imgrec=prefix + ".rec",
                                 data_shape=(3, 32, 32), batch_size=2,
                                 mean_r=1.0, ctx=CPU)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_parse_alike(tmp_path, gz):
    """The MNIST container reader, plain and gzip'd, big-endian int16."""
    import gzip
    import struct

    from incubator_mxnet_tpu.io import record_iter as jri

    from incubator_mxnet_tpu_torch.io import record_iter as tri

    a = np.arange(-12, 12, dtype=">i2").reshape(2, 3, 4)
    raw = struct.pack(">I", (0x0B << 8) | 3) + struct.pack(">3I", 2, 3, 4)
    raw += a.tobytes()
    path = str(tmp_path / ("x.idx" + (".gz" if gz else "")))
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(raw)
    got, want = tri._read_idx_file(path), jri._read_idx_file(path)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a.astype(np.int16))
