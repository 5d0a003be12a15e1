"""``.params`` files cross between the JAX package and the port.

Both write the stock MXNet container (magic 0x112); a file written by
one side loads in the other with the same values and dtypes, and the
same arrays written by each side give byte-identical files.
"""
import struct

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

CPU = tmx.cpu()


def _arrays():
    rng = np.random.RandomState(0)
    return {
        "conv0_weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
        "fc_bias": rng.normal(size=(10,)).astype(np.float32),
        "half": rng.normal(size=(2, 5)).astype(np.float16),
        "steps": np.arange(6, dtype=np.int32).reshape(2, 3),
        "ids": np.arange(4, dtype=np.int64),
        "bytes": np.arange(7, dtype=np.uint8),
        "signed": np.arange(-3, 3, dtype=np.int8),
        "mask": np.array([True, False, True]),
        "scalar_like": np.array([3.5], np.float32),
    }


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        pairs = [(got[k], want[k]) for k in want]
    else:
        assert len(got) == len(want)
        pairs = list(zip(got, want))
    for g, w in pairs:
        g = g.asnumpy() if hasattr(g, "asnumpy") else g
        w = w.asnumpy() if hasattr(w, "asnumpy") else w
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["dict", "list", "single"])
def test_files_are_byte_identical_both_ways(tmp_path, kind):
    arrays = _arrays()
    if kind == "dict":
        jdata = {k: jmx.nd.array(v) for k, v in arrays.items()}
        tdata = convert.ndarrays_from_numpy(arrays, ctx=CPU)
    elif kind == "list":
        jdata = [jmx.nd.array(v) for v in arrays.values()]
        tdata = [tmx.nd.array(v, ctx=CPU) for v in arrays.values()]
    else:
        jdata = jmx.nd.array(arrays["conv0_weight"])
        tdata = tmx.nd.array(arrays["conv0_weight"], ctx=CPU)
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jmx.nd.save(jpath, jdata)
    tmx.nd.save(tpath, tdata)
    assert _read(jpath) == _read(tpath)
    assert struct.unpack("<Q", _read(tpath)[:8])[0] == 0x112
    # each side loads the other's file
    _same(tmx.nd.load(jpath, ctx=CPU), jmx.nd.load(jpath))
    _same(jmx.nd.load(tpath), tmx.nd.load(tpath, ctx=CPU))
    # and writes it back unchanged
    again = str(tmp_path / "again.params")
    tmx.nd.save(again, tmx.nd.load(jpath, ctx=CPU))
    assert _read(again) == _read(jpath)
    jmx.nd.save(again, jmx.nd.load(tpath))
    assert _read(again) == _read(tpath)


def test_loaded_values_and_dtypes(tmp_path):
    path = str(tmp_path / "w.params")
    arrays = _arrays()
    jmx.nd.save(path, {k: jmx.nd.array(v) for k, v in arrays.items()})
    got = tmx.nd.load(path, ctx=CPU)
    assert all(isinstance(v, tmx.nd.NDArray) for v in got.values())
    _same(got, arrays)


def test_bfloat16_is_written_as_float32_on_both_sides(tmp_path):
    """The container's type table has no bfloat16: both packages write it
    as float32, so its values come back exactly and its dtype float32."""
    x = np.random.RandomState(1).normal(size=(3, 4)).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jpath, {"w": jmx.nd.array(x).astype("bfloat16")})
    tmx.nd.save(tpath, {"w": tmx.nd.array(x, ctx=CPU).astype("bfloat16")})
    assert _read(jpath) == _read(tpath)
    back = tmx.nd.load(tpath, ctx=CPU)["w"]
    assert back.dtype == np.float32
    bf = tmx.nd.array(x, ctx=CPU).astype("bfloat16").astype("float32")
    np.testing.assert_array_equal(back.asnumpy(), bf.asnumpy())


def test_legacy_v1_and_pre_v1_blobs_load_on_both_sides(tmp_path):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    head = struct.pack("<QQQ", 0x112, 0, 2)
    v1 = struct.pack("<Ii", 0xF993FAC8, 2) + np.asarray(
        [2, 3], "<i8").tobytes() + struct.pack("<iii", 1, 0, 0) + x.tobytes()
    pre = struct.pack("<I", 2) + np.asarray([2, 3], "<u4").tobytes() \
        + struct.pack("<iii", 1, 0, 0) + x.tobytes()
    path = str(tmp_path / "old.params")
    with open(path, "wb") as f:
        f.write(head + v1 + pre + struct.pack("<Q", 0))
    got, want = tmx.nd.load(path, ctx=CPU), jmx.nd.load(path)
    _same(got, want)
    _same(got, [x, x])


def test_refusals(tmp_path):
    path = str(tmp_path / "bad.params")
    with open(path, "wb") as f:
        f.write(b"not a params file")
    with pytest.raises(ValueError, match=".params"):
        tmx.nd.load(path, ctx=CPU)
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, 1) + struct.pack("<Ii",
                                                               0xF993FAC9, 2))
    with pytest.raises(ValueError, match="sparse"):
        tmx.nd.load(path, ctx=CPU)
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, 1) + struct.pack("<I", 0xF993FAC9))
    with pytest.raises(ValueError, match="truncated"):
        tmx.nd.load(path, ctx=CPU)
    with pytest.raises(ValueError, match="NDArray, list"):
        tmx.nd.save(path, "weights")
