"""The port's ``rtc`` (CUDA C compiled by NVRTC) on the CPU host: the
signature grammar, the two user kernels' plain versions against the JAX
package's Pallas kernels of the same tests (interpret mode), and the
refusals.  Compiling and launching need a card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` [2c] do that.

Tolerances: R1 (``2x + 1``) exact; R2 (``a @ b``) rtol 1e-5 / atol 1e-5
in float32 (the Pallas dot and torch's sum in another order).
"""
import re

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import rtc

CPU = tmx.cpu()

# the Pallas sources of tests/test_subgraph_rtc.py
_PALLAS_SCALE = """
def scale_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0 + 1.0
"""
_PALLAS_MM = """
def mm_kernel(a_ref, b_ref, o_ref):
    o_ref[...] = jnp.dot(a_ref[...], b_ref[...],
                         preferred_element_type=jnp.float32)
"""


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, int n",
     [("float", True, True, "x"), ("float", True, False, "y"),
      ("int", False, False, "n")]),
    ("double*out,const __half* in,int64_t count",
     [("double", True, False, "out"), ("__half", True, True, "in"),
      ("int64_t", False, False, "count")]),
    ("uint8_t *a, int8_t b, char *c, int32_t d",
     [("uint8_t", True, False, "a"), ("int8_t", False, False, "b"),
      ("char", True, False, "c"), ("int32_t", False, False, "d")]),
    ("const float *, int", [("float", True, True, ""),
                            ("int", False, False, "")]),
    ("  const   float  *  x ", [("float", True, True, "x")]),
])
def test_signature_grammar(sig, want):
    got = [(a.ctype, a.is_pointer, a.is_const, a.name)
           for a in rtc.parse_signature(sig)]
    assert got == want


def test_signature_dtypes():
    args = rtc.parse_signature("float *a, double *b, __half *c, uint8_t *d, "
                               "int *e, int32_t *f, int8_t *g, char *h, "
                               "int64_t *i")
    assert [a.dtype for a in args] == [
        torch.float32, torch.float64, torch.float16, torch.uint8,
        torch.int32, torch.int32, torch.int8, torch.int8, torch.int64]


@pytest.mark.parametrize("sig", ["float **x", "const", "float x y",
                                 "const const float *x", "", "float *x,"])
def test_signature_malformed(sig):
    with pytest.raises(ValueError, match="invalid kernel argument"):
        rtc.parse_signature(sig)


@pytest.mark.parametrize("sig", ["long x", "unsigned *y", "float16 *z",
                                 "const bool *m"])
def test_signature_unsupported_type(sig):
    with pytest.raises(TypeError, match="unsupported kernel argument type"):
        rtc.parse_signature(sig)


@pytest.mark.parametrize("name", sorted(rtc.USER_KERNELS))
def test_user_sources_declare_their_signatures(name):
    """Each ``csrc/rtc/<name>.cu`` declares an ``extern "C"`` kernel whose
    parameters are the signature the port launches it with."""
    src = rtc.user_source(name)
    m = re.search(r'extern "C" __global__ void(?: __launch_bounds__\(\d+\))?'
                  r'\s+%s\(([^)]*)\)' % name, src)
    assert m, name
    declared = [(a.ctype, a.is_pointer, a.is_const, a.name)
                for a in rtc.parse_signature(m.group(1))]
    used = [(a.ctype, a.is_pointer, a.is_const, a.name)
            for a in rtc.parse_signature(rtc.USER_KERNELS[name])]
    assert declared == used


@pytest.mark.parametrize("shape", [(2, 4), (3, 8, 16)])
def test_r1_plain_matches_the_pallas_kernel(shape):
    x = np.random.RandomState(0).normal(size=shape).astype(np.float32)
    k = jmx.rtc.PallasModule(_PALLAS_SCALE, exports=["scale_kernel"]) \
        .get_kernel("scale_kernel")
    want = k.launch([jmx.nd.array(x)], out_shape=(shape, "float32"))
    got = rtc.scale_plain(tmx.nd.array(x, ctx=CPU))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("m,k,n", [(16, 32, 8), (24, 16, 40)])
def test_r2_plain_matches_the_pallas_kernel(m, k, n):
    rng = np.random.RandomState(1)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    kern = jmx.rtc.PallasModule(_PALLAS_MM).get_kernel("mm_kernel")
    want = kern.launch([jmx.nd.array(a), jmx.nd.array(b)],
                       out_shape=((m, n), "float32"))
    got = rtc.mm_plain(tmx.nd.array(a, ctx=CPU), tmx.nd.array(b, ctx=CPU))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_module_needs_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtc.CudaModule(rtc.user_source("scale_kernel"),
                       exports=["scale_kernel"])


def test_missing_export_raises_value_error(monkeypatch):
    """As the JAX package's ``PallasModule`` does
    (``tests/test_subgraph_rtc.py``), before anything is compiled."""
    _no_card(monkeypatch)
    with pytest.raises(ValueError, match="not defined"):
        rtc.CudaModule("x = 1", exports=["nope"])
    with pytest.raises(ValueError):
        jmx.rtc.PallasModule("x = 1", exports=["nope"])


def test_template_exports_pass_the_export_check(monkeypatch):
    """A C++ export names its kernel by its identifier (``ns::axpy<float>``
    is defined by ``axpy``); without a card the module then refuses for
    the card, not for the export."""
    _no_card(monkeypatch)
    src = ("namespace ns { template <typename T> __global__ void "
           "axpy(T a, T* x) {} }")
    with pytest.raises(RuntimeError, match="CUDA"):
        rtc.CudaModule(src, exports=["ns::axpy<float>"])
    with pytest.raises(ValueError, match="not defined"):
        rtc.CudaModule(src, exports=["ns::saxpy<float>"])


def test_pallas_module_names_cuda_module():
    with pytest.raises(NotImplementedError, match="CudaModule"):
        rtc.PallasModule(_PALLAS_SCALE, exports=["scale_kernel"])


def _kernel(name="scale_kernel"):
    """A kernel object without a compiled module: launch validates its
    arguments before it touches the driver."""
    return rtc.CudaKernel(None, name,
                          rtc.parse_signature(rtc.USER_KERNELS[name]))


def test_launch_refuses_the_cpu():
    k = _kernel()
    x = tmx.nd.zeros((4,), ctx=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        k.launch([x, x, 4], CPU, (1, 1, 1), (4, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        rtc.launch_scale(k, x, CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtc.launch_mm(_kernel("mm_kernel"), tmx.nd.zeros((2, 3), ctx=CPU),
                      tmx.nd.zeros((3, 2), ctx=CPU), CPU)
    assert k.launches == 0


def test_launch_refuses_a_cpu_array(monkeypatch):
    """With a CUDA ctx, a CPU array is refused before any launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    k = _kernel()
    x = tmx.nd.zeros((4,), ctx=CPU)
    with pytest.raises(RuntimeError, match="CUDA arrays"):
        k.launch([x, x, 4], tmx.gpu(0), (1, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="takes 3 arguments"):
        k.launch([x, x], tmx.gpu(0), (1, 1, 1), (4, 1, 1))
    with pytest.raises(TypeError, match="must be an NDArray"):
        k.launch([1.0, x, 4], tmx.gpu(0), (1, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="3 values"):
        k.launch([x, x, 4], tmx.gpu(0), (1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="mm_kernel takes"):
        rtc.launch_mm(_kernel("mm_kernel"), tmx.nd.zeros((2, 3), ctx=CPU),
                      tmx.nd.zeros((2, 3), ctx=CPU), tmx.gpu(0))
    assert k.launches == 0


def test_no_nvrtc_raises_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(rtc, "_nvrtc_candidates", lambda: iter(()))
    monkeypatch.setattr(rtc, "_libs", {})
    with pytest.raises(RuntimeError, match="libnvrtc not found"):
        rtc._nvrtc()


def _mm_defines():
    """The integer ``#define``s of ``csrc/rtc/mm_kernel.cu``, each evaluated
    over the ones before it."""
    out = {}
    for name, expr in re.findall(r"^#define (MM_\w+) (.+)$",
                                 rtc.user_source("mm_kernel"), re.M):
        out[name] = int(eval(expr, {}, dict(out)))
    return out


class _FakeMM:
    """Records what ``launch_mm`` hands the kernel."""

    def __init__(self):
        self.calls = []

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        self.calls.append((args, grid_dims, block_dims, shared_mem))


@pytest.mark.parametrize("m,k,n", [(257, 33, 130), (1, 5, 1), (1000, 300, 129),
                                   (8192, 1024, 1024), (256, 64, 384)])
def test_launch_mm_geometry_matches_the_source(m, k, n):
    """Grid over ceil(N / tile) x ceil(M / tile) blocks; block size and
    dynamic shared memory as the kernel's own #defines say, for ragged and
    aligned shapes."""
    d = _mm_defines()
    assert (rtc.MM_TILE, rtc.MM_THREADS, rtc.MM_SMEM_BYTES) == (
        d["MM_TILE"], d["MM_THREADS"], d["MM_SMEM_BYTES"])
    assert d["MM_SMEM_BYTES"] == d["MM_STAGES"] * 4 * (
        d["MM_TILE"] * d["MM_PITCH_A"] + d["MM_KSTEP"] * d["MM_PITCH_B"])
    assert d["MM_SMEM_BYTES"] <= 227 * 1024
    fake = _FakeMM()
    a, b = tmx.nd.zeros((m, k), ctx=CPU), tmx.nd.zeros((k, n), ctx=CPU)
    c = rtc.launch_mm(fake, a, b, CPU)
    (args, grid, block, smem), = fake.calls
    tile = d["MM_TILE"]
    assert grid == (-(-n // tile), -(-m // tile), 1)
    assert grid[0] * tile >= n > (grid[0] - 1) * tile
    assert grid[1] * tile >= m > (grid[1] - 1) * tile
    assert block == (d["MM_THREADS"], 1, 1)
    assert smem == d["MM_SMEM_BYTES"]
    assert args[:3] == [a, b, c] and args[3:] == [m, n, k]
    assert c.shape == (m, n)


def _scale_defines():
    """The integer ``#define``s of ``csrc/rtc/scale_kernel.cu``."""
    out = {}
    for name, expr in re.findall(r"^#define (SCALE_\w+) (.+)$",
                                 rtc.user_source("scale_kernel"), re.M):
        out[name] = int(eval(expr, {}, dict(out)))
    return out


def _strided_cover(count, threads, unroll=1):
    """How often ``for (v0 = tid; v0 < count; v0 += unroll * threads) for
    u < unroll: v = v0 + u * threads; if (v < count)`` visits each index,
    over the threads."""
    hits = np.zeros(count, dtype=np.int64)
    t = np.arange(threads)
    for i in range(-(-count // (unroll * threads))):
        v0 = t + i * unroll * threads
        for u in range(unroll):
            v = v0 + u * threads
            hits[v[(v0 < count) & (v < count)]] += 1
    return hits


def _r1_writes(n, x_off, y_off, threads, unroll):
    """How often R1 writes each of y's n elements, with x and y ``x_off``
    and ``y_off`` floats past a 16-byte boundary, on ``threads`` threads
    in all: scale_kernel's split, written out in numpy."""
    if (x_off - y_off) % 4:
        return _strided_cover(n, threads)       # every element scalar
    head = min(n, (4 - y_off % 4) % 4)
    nvec = (n - head) // 4
    tail = head + 4 * nvec
    hits = np.zeros(n, dtype=np.int64)
    hits[:head] += _strided_cover(head, threads)
    hits[tail:] += _strided_cover(n - tail, threads)
    hits[head:tail] += np.repeat(_strided_cover(nvec, threads, unroll), 4)
    return hits


class _FakeScale:
    def __init__(self):
        self.calls = []

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        self.calls.append((args, grid_dims, block_dims, shared_mem))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 8388608])
def test_launch_scale_geometry_covers_every_element(monkeypatch, n):
    """launch_scale's grid (SCALE_BLOCKS_PER_SM blocks of SCALE_THREADS an
    SM, fewer for small n) and R1's head / float4 / tail split write each
    element of y once, for x and y 0-3 floats off the 16-byte grid."""
    d = _scale_defines()
    assert (rtc.SCALE_THREADS, rtc.SCALE_BLOCKS_PER_SM) == (
        d["SCALE_THREADS"], d["SCALE_BLOCKS_PER_SM"])
    monkeypatch.setattr(rtc, "_sm_count", lambda ctx: 132)
    fake = _FakeScale()
    for off in range(4):
        x = tmx.nd.NDArray(torch.zeros(n + 4)[off:off + n])
        y = rtc.launch_scale(fake, x, CPU)
        (args, grid, block, smem), = fake.calls[-1:]
        assert args == [x, y, n] and y.shape == (n,)
        assert y._data.data_ptr() % 16 == 0 and smem == 0
    blocks = min(132 * d["SCALE_BLOCKS_PER_SM"],
                 -(-n // (4 * d["SCALE_THREADS"])))
    assert {c[1] for c in fake.calls} == {(blocks, 1, 1)}
    assert grid == rtc.scale_grid(n, CPU)
    assert block == (d["SCALE_THREADS"], 1, 1)
    threads = blocks * d["SCALE_THREADS"]
    for x_off in range(4):
        for y_off in range(4):
            hits = _r1_writes(n, x_off, y_off, threads, d["SCALE_UNROLL"])
            assert np.all(hits == 1), (x_off, y_off)
