"""The port's RecordIO against the JAX package's (``recordio.py``).

Records written by either package read in the other, sequential and
indexed, with the same bytes on disk and the same ``.idx`` files; IR
headers with scalar and vector labels pack alike; ``.npy`` and ``.jpg``
payloads decode to equal images (PIL decodes the JPEG on both sides); a
torn final record warns and ends the file; a corrupt record raises the
same error class with the same offset.  Everything is exact.
"""
import numpy as np
import pytest

from incubator_mxnet_tpu import recordio as jrec

from incubator_mxnet_tpu_torch import recordio as trec


def _payloads():
    rng = np.random.RandomState(0)
    out = [rng.bytes(n) for n in (0, 1, 3, 4, 5, 17, 1000)]
    # payloads holding the magic word are split into frames
    magic = jrec._MAGIC_BYTES
    out += [magic, b"ab" + magic + b"cd" + magic + b"e", magic * 3]
    return out


def _write(mod, prefix, payloads, indexed):
    if indexed:
        w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
    else:
        w = mod.MXRecordIO(prefix + ".rec", "w")
        for p in payloads:
            w.write(p)
    w.close()


def _read(mod, prefix, n, indexed):
    if indexed:
        r = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
        out = [r.read_idx(i) for i in reversed(range(n))][::-1]
        assert list(r.keys) == list(range(n))
    else:
        r = mod.MXRecordIO(prefix + ".rec", "r")
        out = [r.read() for _ in range(n)]
        assert r.read() is None
    r.close()
    return out


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
def test_records_cross_packages(tmp_path, writer, reader, indexed):
    payloads = _payloads()
    _write(writer, str(tmp_path / "w"), payloads, indexed)
    assert _read(reader, str(tmp_path / "w"), len(payloads),
                 indexed) == payloads
    # the same bytes on disk (and the same index) from either writer
    other = trec if writer is jrec else jrec
    _write(other, str(tmp_path / "o"), payloads, indexed)
    for ext in (".rec", ".idx") if indexed else (".rec",):
        assert (tmp_path / ("w" + ext)).read_bytes() == \
            (tmp_path / ("o" + ext)).read_bytes()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(7.0)])
def test_pack_unpack_labels(label):
    header = (0, label, 42, 7)
    s = trec.pack(header, b"payload")
    assert s == jrec.pack(header, b"payload")
    th, tp = trec.unpack(s)
    jh, jp = jrec.unpack(s)
    assert tp == jp == b"payload"
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".npy", ".jpg", ".png"])
def test_image_payloads_decode_alike(fmt):
    img = np.random.RandomState(1).randint(0, 255, (20, 24, 3), np.uint8)
    header = trec.IRHeader(0, 5.0, 1, 0)
    s = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(header, img, quality=90, img_fmt=fmt)
    (th, timg), (jh, jimg) = trec.unpack_img(s), jrec.unpack_img(s)
    assert th == jh
    assert timg.dtype == jimg.dtype == np.uint8
    np.testing.assert_array_equal(timg, jimg)
    if fmt != ".jpg":
        np.testing.assert_array_equal(timg, img)


def test_torn_final_record_warns_and_ends(tmp_path):
    path = str(tmp_path / "t.rec")
    _write(trec, path[:-4], [b"x" * 10, b"y" * 40], indexed=False)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-20])  # cut inside the second record's payload
    for mod in (trec, jrec):
        r = mod.MXRecordIO(path, "r")
        assert r.read() == b"x" * 10
        with pytest.warns(UserWarning, match="torn final record"):
            assert r.read() is None
        r.close()


def test_corrupt_record_raises_the_same_error(tmp_path):
    path = str(tmp_path / "c.rec")
    _write(trec, path[:-4], [b"a" * 8, b"b" * 8, b"c" * 8], indexed=False)
    data = bytearray(open(path, "rb").read())
    data[16] ^= 0xFF  # the second record's magic
    open(path, "wb").write(bytes(data))
    got = []
    for mod in (trec, jrec):
        r = mod.MXRecordIO(path, "r")
        assert r.read() == b"a" * 8
        with pytest.raises(IOError, match="invalid record magic") as e:
            r.read()
        # resynced past the bad frame: the next record reads
        assert r.read() == b"c" * 8
        got.append((type(e.value), e.value.offset, e.value.path))
        r.close()
    assert got[0] == got[1] == (OSError, 16, path)


def test_reader_and_writer_refuse_the_other_direction(tmp_path):
    path = str(tmp_path / "r.rec")
    w = trec.MXRecordIO(path, "w")
    with pytest.raises(ValueError, match="opened for writing"):
        w.read()
    w.close()
    r = trec.MXRecordIO(path, "r")
    with pytest.raises(ValueError, match="opened for reading"):
        r.write(b"x")
    r.close()
    with pytest.raises(ValueError, match="Invalid flag"):
        trec.MXRecordIO(path, "a")
