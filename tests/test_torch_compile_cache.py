"""The port's compile cache (``parallel/aot.py`` ``CompileCache``) and
``fault_injection.corrupt_compile_cache``, on the CPU, with a stand-in
build function in place of ``nvcc`` (the contract of the reference's
``CompileCache``, ``incubator_mxnet_tpu/parallel/aot.py:167-181``):

- a store writes the entry and its sha256 sidecar; a load verifies the
  sidecar before it opens the entry; hits, misses, dropped entries and
  store failures are counted;
- a truncated, bit-flipped or garbage entry, or one whose sidecar is
  missing or differs, is warned about, deleted and rebuilt, and the
  loader never sees it;
- the ``max_bytes`` sweep removes other keys' entries oldest first and
  never the one just stored; stale temporary files go too;
- ``_kernels.build()`` goes through the cache: a damaged library is
  rebuilt under the build lock and the rebuilt one loaded.
"""
import os
import time
import warnings

import pytest

from incubator_mxnet_tpu_torch import _kernels
from incubator_mxnet_tpu_torch.parallel import aot
from incubator_mxnet_tpu_torch.parallel import checkpoint
from incubator_mxnet_tpu_torch.parallel import fault_injection as fi


def _build_fn(payload, calls):
    def build(path):
        calls.append(path)
        with open(path, "wb") as f:
            f.write(payload)
    return build


def _reader(opened):
    def opener(path):
        with open(path, "rb") as f:
            data = f.read()
        opened.append(data)
        return data
    return opener


def _cache(tmp_path, **kw):
    return aot.CompileCache(str(tmp_path / "cache"), prefix="lib_", **kw)


def test_store_then_hit(tmp_path):
    cache = _cache(tmp_path)
    calls, opened = [], []
    assert cache.load("k1", _reader(opened)) is None
    path = cache.store("k1", _build_fn(b"A" * 1000, calls))
    assert path == cache.path("k1") and os.path.exists(path)
    assert os.path.exists(path + aot.CompileCache.SIDECAR)
    assert len(calls) == 1 and ".tmp." in calls[0]
    assert not os.path.exists(calls[0])
    assert cache.load("k1", _reader(opened)) == b"A" * 1000
    assert cache.counters() == {"hits": 1, "misses": 1, "dropped": 0,
                                "store_failures": 0}


def _damage_sidecar(cache, key):
    os.remove(cache.path(key) + aot.CompileCache.SIDECAR)


def _foreign_sidecar(cache, key):
    other = cache.path("k2")
    cache.store("k2", _build_fn(b"B" * 900, []))
    os.replace(other + aot.CompileCache.SIDECAR,
               cache.path(key) + aot.CompileCache.SIDECAR)


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "garbage",
                                    "missing_sidecar", "foreign_sidecar"])
def test_damaged_entry_is_dropped_and_rebuilt(tmp_path, damage):
    cache = _cache(tmp_path)
    payload = bytes(range(256)) * 8
    cache.store("k1", _build_fn(payload, []))
    if damage in ("truncate", "bitflip", "garbage"):
        touched = fi.corrupt_compile_cache(cache.directory, what=damage)
        assert touched == cache.path("k1")
    elif damage == "missing_sidecar":
        _damage_sidecar(cache, "k1")
    else:
        _foreign_sidecar(cache, "k1")
    opened = []
    with pytest.warns(UserWarning, match="damaged entry"):
        assert cache.load("k1", _reader(opened)) is None
    assert opened == []            # the damaged bytes never reached it
    assert not os.path.exists(cache.path("k1"))
    assert cache.dropped == 1 and cache.hits == 0
    calls = []
    cache.store("k1", _build_fn(payload, calls))
    assert len(calls) == 1
    assert cache.load("k1", _reader(opened)) == payload
    assert cache.hits == 1


def test_loader_refusal_is_a_drop(tmp_path):
    cache = _cache(tmp_path)
    cache.store("k1", _build_fn(b"not a library", []))

    def refuse(path):
        raise OSError("invalid ELF header")

    with pytest.warns(UserWarning, match="refused by the loader"):
        assert cache.load("k1", refuse) is None
    assert cache.dropped == 1 and not os.path.exists(cache.path("k1"))


def test_corrupt_compile_cache_validation(tmp_path):
    cache = _cache(tmp_path)
    os.makedirs(cache.directory)
    with pytest.raises(ValueError, match="no compile-cache entries"):
        fi.corrupt_compile_cache(cache.directory)
    cache.store("k1", _build_fn(b"x" * 64, []))
    with pytest.raises(ValueError, match="what must be"):
        fi.corrupt_compile_cache(cache.directory, what="melt")
    cache.store("k0", _build_fn(b"y" * 64, []))
    assert fi.corrupt_compile_cache(cache.directory, which=1) == \
        cache.path("k1")
    assert os.path.getsize(cache.path("k1")) == 32


def test_store_failure_is_counted_and_still_usable(tmp_path, monkeypatch):
    cache = _cache(tmp_path)

    def failing_write(path, data):
        raise OSError(28, "No space left on device (injected)")

    monkeypatch.setattr(checkpoint, "_write_bytes", failing_write)
    with pytest.warns(UserWarning, match="failed to store"):
        path = cache.store("k1", _build_fn(b"C" * 10, []))
    assert cache.store_failures == 1
    assert path != cache.path("k1") and open(path, "rb").read() == b"C" * 10
    assert not os.path.exists(cache.path("k1"))
    assert cache.load("k1", _reader([])) is None and cache.misses == 1


def test_sweep_keeps_newest_and_current(tmp_path):
    cache = _cache(tmp_path, max_bytes=2500)
    t = time.time() - 1000
    for i, key in enumerate(["a", "b", "c"]):
        cache.store(key, _build_fn(b"z" * 1000, []))
        os.utime(cache.path(key), (t + i, t + i))
    # three entries of 1000 bytes over a 2500-byte cap: the oldest went
    assert not os.path.exists(cache.path("a"))
    assert not os.path.exists(cache.path("a") + aot.CompileCache.SIDECAR)
    assert os.path.exists(cache.path("b")) and os.path.exists(cache.path("c"))
    stale = os.path.join(cache.directory, "lib_x.tmp.1.so")
    with open(stale, "wb") as f:
        f.write(b"q")
    os.utime(stale, (t, t))
    # an entry larger than the cap stays: it is the one in use
    cache.store("big", _build_fn(b"w" * 4000, []))
    assert os.path.exists(cache.path("big"))
    assert not os.path.exists(cache.path("b"))
    assert not os.path.exists(cache.path("c"))
    assert not os.path.exists(stale)


class _StubLib:
    """Stands in for the ``ctypes.CDLL`` of the kernel library."""

    def __init__(self, path):
        with open(path, "rb") as f:
            self.data = f.read()
        if not self.data.startswith(b"\x7fELF"):
            raise OSError("%s: invalid ELF header" % path)

    def __getattr__(self, name):
        def entry(*args):
            return 0
        return entry


def test_kernel_build_goes_through_the_cache(tmp_path, monkeypatch):
    builds = []

    def fake_compile(path):
        builds.append(path)
        with open(path, "wb") as f:
            f.write(b"\x7fELF" + b"\x00" * 4092)

    monkeypatch.setattr(_kernels, "_BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(_kernels, "_cache", None)
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_compile", fake_compile)
    monkeypatch.setattr(_kernels, "_open", _StubLib)
    assert _kernels.build() >= 0.0 and len(builds) == 1
    assert isinstance(_kernels._lib, _StubLib)
    assert _kernels.build() == 0.0 and len(builds) == 1   # loaded once
    cache = _kernels.compile_cache()
    assert cache.counters() == {"hits": 0, "misses": 1, "dropped": 0,
                                "store_failures": 0}
    key = _kernels._source_key()
    assert os.path.exists(cache.path(key))
    # a new process finds the library: a hit, no build
    monkeypatch.setattr(_kernels, "_lib", None)
    _kernels.build()
    assert cache.hits == 1 and len(builds) == 1
    # a damaged library is rebuilt, never loaded
    for what in ("truncate", "bitflip", "garbage"):
        fi.corrupt_compile_cache(str(_kernels._BUILD_DIR), what=what)
        monkeypatch.setattr(_kernels, "_lib", None)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _kernels.build()
        assert any("damaged entry" in str(x.message) for x in w)
        assert _kernels._lib.data == b"\x7fELF" + b"\x00" * 4092
    assert len(builds) == 4 and cache.dropped == 3
