"""K7 (``fused_bn.bn_copy``, the copy yardstick of K1 and K2) and
``tools/bn_kernel_bench_torch.py`` on the CPU.

K7's plain version is ``x.clone()``: exact.  K7's geometry (the channels
a block copies, its runs, and each run's scalar head, 16-byte vectors and
scalar tail, from the ``#define``s of ``csrc/ghost_bn_walk.cuh``) is
modelled here and must write every element once.  The tool's
``--dry-run`` rows keep the JAX tool's JSON schema (``tools/
bn_kernel_bench.py --dry-run --format json``), with ``stock_xla`` renamed
``plain_torch``, and the same legs; the nine ResNet-50 BN shapes are the
JAX tool's.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import _kernels
from incubator_mxnet_tpu_torch.parallel import fused_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ng", [((32, 8, 5, 5), 16), ((6, 3, 7, 2), 3),
                                      ((4, 16, 1, 1), 1)])
def test_bn_copy_plain_is_an_exact_copy(dtype, shape, ng):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(0)) \
        .to(dtype)
    before = _kernels.launch_counts()
    y = fused_bn.bn_copy(x, ng)
    assert _kernels.launch_counts() == before     # CPU: no kernel
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_bn_copy_refuses_what_k1_refuses():
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        fused_bn.bn_copy(torch.zeros(4, 3, 2), 2)
    with pytest.raises(ValueError, match="does not divide"):
        fused_bn.bn_copy(torch.zeros(6, 3, 2, 2), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bn.bn_copy(torch.zeros(4, 3, 2, 2, dtype=torch.float16), 2)


class _FakeTrace:
    """Stands in for ``torch.profiler.profile``: each session's device
    events are the next list of (name, us) given, in launch order (the
    last list again once they run out)."""

    def __init__(self, *sessions):
        self._sessions = list(sessions)

    def __call__(self, activities):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        trace = self._sessions.pop(0) if len(self._sessions) > 1 \
            else self._sessions[0]
        out = []
        for i, (name, us) in enumerate(trace):
            out.append(type("Ev", (), dict(
                name=name, device_type=torch.autograd.DeviceType.CUDA,
                time_range=type("R", (), dict(
                    start=10 * i, elapsed_us=lambda self, us=us: us))())))
        return out


def test_flushed_device_ms_leaves_out_only_the_flushes(monkeypatch):
    """The trace is split at the flushes (a uint8 fill), so an f32 fill
    that the timed function launches itself is still timed; the first
    events of a session may be missing (only the last calls are read); a
    session that lost its calls is taken again, and after ``SESSIONS``
    such sessions, or with two launches of the named kernel in a call,
    the measurement is refused."""
    import torch.profiler

    tool = _load("bn_kernel_bench_torch")
    monkeypatch.setattr(tool, "FLUSH_BYTES", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    flush = "vectorized_elementwise_kernel<4, FillFunctor<unsigned char>>"
    fill = "vectorized_elementwise_kernel<4, FillFunctor<float>>"
    call = [(flush, 100.0), (fill, 3.0), ("bn_copy_kernel<bf16>", 5.0)]
    # the session's first events lost: a call cut in half, then 6 whole
    trace = call[1:] + call * 6
    monkeypatch.setattr(torch.profiler, "profile", _FakeTrace(trace))
    assert tool.flushed_device_ms(lambda: None, 4, "cpu") == 8.0 / 1e3
    assert tool.flushed_device_ms(lambda: None, 4, "cpu", "bn_copy") == \
        5.0 / 1e3
    assert tool.retried == 0
    with pytest.raises(AssertionError, match="one launch of mm"):
        tool.flushed_device_ms(lambda: None, 4, "cpu", "mm")
    assert tool.retried == tool.SESSIONS - 1
    # an empty session, then one cut short, then a whole one
    monkeypatch.setattr(tool, "retried", 0)
    monkeypatch.setattr(torch.profiler, "profile",
                        _FakeTrace([], call * 3, trace))
    assert tool.flushed_device_ms(lambda: None, 4, "cpu", "bn_copy") == \
        5.0 / 1e3
    assert tool.retried == 2
    for bad in (call[1:] + call * 3, call * 6 + call[2:] * 1 + call):
        monkeypatch.setattr(torch.profiler, "profile", _FakeTrace(bad))
        with pytest.raises(AssertionError, match="want 4 calls"):
            tool.flushed_device_ms(lambda: None, 4, "cpu", "bn_copy")


def test_tool_shapes_are_the_jax_tools():
    assert _load("bn_kernel_bench_torch").SHAPES == \
        _load("bn_kernel_bench").SHAPES


def test_tool_legs():
    legs = _load("bn_kernel_bench_torch").legs
    shapes = [(8, 64, 2, 2), (8, 128, 2, 2)]
    assert legs(shapes, False, False) == [(8, 64, 2, 2, False, False),
                                          (8, 128, 2, 2, False, False)]
    assert legs(shapes, True, True)[1:] == [(8, 128, 2, 2, False, False),
                                            (8, 128, 2, 2, True, False),
                                            (8, 128, 2, 2, True, True)]


def test_dry_run_rows_keep_the_jax_tools_schema(capsys):
    _load("bn_kernel_bench_torch").main(["--dry-run", "--format", "json"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "bn_kernel_bench.py"),
         "--dry-run", "--format", "json"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    ref = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == len(ref) == 7
    want_keys = [k.replace("stock_xla", "plain_torch") for k in ref[0]]
    for row, r in zip(rows, ref):
        assert list(row) == want_keys
        assert (row["residual"], row["dual"]) == (r["residual"], r["dual"])
        assert row["variant"] == "k1" and row["bwd_variant"] == "k2"
        assert all(row[k] > 0 for k in row if k.endswith("_ms"))


def test_table_format_and_out_file(tmp_path, capsys):
    path = tmp_path / "rows.jsonl"
    _load("bn_kernel_bench_torch").main(["--dry-run", "--out", str(path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:3] == ["shape", "residual", "dual"]
    assert len(lines) == 8
    assert len(path.read_text().splitlines()) == 7


# ---------------------------------------------------------------------------
# K7's geometry, modelled from csrc/ghost_bn_walk.cuh
# ---------------------------------------------------------------------------

WALK = os.path.join(ROOT, "incubator_mxnet_tpu_torch", "csrc",
                    "ghost_bn_walk.cuh")


def _walk_defines():
    """The integer ``#define``s of the walk header, each evaluated over the
    ones before it."""
    out = {}
    with open(WALK) as f:
        for name, expr in re.findall(r"^#define (WALK_\w+) (.+)$", f.read(),
                                     re.M):
            out[name] = int(eval(expr, {}, dict(out)))
    return out


def _walk_channels(c, hw, itemsize, ng, groups, max_kc=None):
    """The test's model of ``walk_channels`` in the walk header: the
    smallest divisor kc of C (at most ``max_kc``) whose run of kc * HW
    elements is whole 16-byte vectors and whose block reads at least
    WALK_MIN_BLOCK_BYTES, unless the grid (C / kc, G) would fall below
    WALK_MIN_BLOCKS blocks: then the largest such divisor below it; 1 when
    no divisor gives whole vectors."""
    d = _walk_defines()
    best = 0
    for kc in range(1, min(c, max_kc or c) + 1):
        if c % kc or kc * hw * itemsize % d["WALK_VEC_BYTES"]:
            continue
        if best and (c // kc) * groups < d["WALK_MIN_BLOCKS"]:
            break
        best = kc
        if ng * kc * hw * itemsize >= d["WALK_MIN_BLOCK_BYTES"]:
            break
    return best or 1


def _strided_cover(count, threads, unroll=1):
    """How often the block's loop ``for (v0 = t; v0 < count; v0 += unroll
    * threads) for u < unroll: v = v0 + u * threads; if (v < count)``
    visits each index, over the threads t."""
    hits = np.zeros(count, dtype=np.int64)
    t = np.arange(threads)
    for i in range(-(-count // (unroll * threads))):
        v0 = t + i * unroll * threads
        for u in range(unroll):
            v = v0 + u * threads
            hits[v[(v0 < count) & (v < count)]] += 1
    return hits


def _run_iter_cover(ng, nvec, threads, unroll):
    """How often ``copy_runs``' vector loop visits each (run, vector) pair:
    thread t starts at pair t of the row-major sequence and steps
    ``threads`` pairs at a time with ``RunIter`` (p += step / nvec, v +=
    step % nvec, one carry), ``unroll`` pairs a loop, while p < ng."""
    hits = np.zeros((ng, nvec), dtype=np.int64)
    p, v = np.divmod(np.arange(threads), nvec)
    dp, dv = divmod(threads, nvec)
    while (p < ng).any():
        for _ in range(unroll):
            ok = p < ng
            np.add.at(hits, (p[ok], v[ok]), 1)
            p, v = p + dp, v + dv
            p, v = np.where(v >= nvec, p + 1, p), np.where(v >= nvec,
                                                           v - nvec, v)
    return hits


def _k7_runs(shape, itemsize, ng, x_offset):
    """``(kc, flat, base, head, nvec, tail)``: K7's channels a block,
    whether ``copy_runs`` walks each block's runs as one sequence of
    vectors, and per run (block (cb, g), image p, in that order) its first
    element and its split, as ``bn_copy_kernel``, ``copy_runs`` and
    ``copy_run`` compute them for an x ``x_offset`` elements off y's
    16-byte grid (y starts on it)."""
    d = _walk_defines()
    n, c, h, w = shape
    hw, groups = h * w, n // ng
    kc = _walk_channels(c, hw, itemsize, ng, groups)
    run, plane = kc * hw, c * hw
    g, cb, p = np.meshgrid(np.arange(groups), np.arange(c // kc),
                           np.arange(ng), indexing="ij")
    base = ((g * ng + p) * plane + cb * run).ravel()
    vb = d["WALK_VEC_BYTES"]
    vec = vb // itemsize
    flat = x_offset * itemsize % vb == 0 and run % vec == 0 \
        and plane % vec == 0
    if x_offset * itemsize % vb:
        head = np.full_like(base, run)           # every element scalar
    else:
        head = np.minimum((vb - base * itemsize % vb) % vb // itemsize, run)
    nvec = (run - head) // vec
    return kc, flat, base, head, nvec, head + nvec * vec


def _check_k7_geometry(shape, itemsize, ng, x_offset=0):
    """Every element is written once: the runs tile the tensor, each run
    splits into head, vectors and tail, and the block's threads visit
    each scalar and each vector once, on either path of copy_runs."""
    d = _walk_defines()
    threads, unroll = d["WALK_THREADS"], d["WALK_UNROLL"]
    n, c, h, w = shape
    kc, flat, base, head, nvec, tail = _k7_runs(shape, itemsize, ng,
                                                x_offset)
    run = kc * h * w
    assert c % kc == 0 and n // ng <= 65535
    assert np.array_equal(np.sort(base), np.arange(0, n * c * h * w, run))
    vec = d["WALK_VEC_BYTES"] // itemsize
    assert np.all((head >= 0) & ((head < vec) | (head == run)))
    assert np.all(head + nvec * vec + (run - tail) == run)
    if flat:          # the vectors of a block's runs as one sequence
        assert np.all(head == 0) and np.all(nvec == run // vec)
        assert np.all(_run_iter_cover(ng, run // vec, threads, unroll) == 1)
    else:             # run by run
        for count in set(head.tolist()) | set((run - tail).tolist()):
            assert np.all(_strided_cover(count, threads) == 1)
        for count in set(nvec.tolist()):
            assert np.all(_strided_cover(count, threads, unroll) == 1)
    return kc, flat, base, head, tail


def test_walk_constants_match_the_header():
    """The header's kc rule is the one modelled here (same tests, same
    constants), and K7 takes its grid from the exported
    ``bn_copy_channels``, which ``fused_bn.bn_copy_channels`` reads."""
    d = _walk_defines()
    assert (d["WALK_VEC_BYTES"], d["WALK_MIN_BLOCK_BYTES"],
            d["WALK_MIN_BLOCKS"]) == (16, 24 * 1024, 4 * 132)
    src = open(WALK).read()
    body = src[src.index("inline int walk_channels("):]
    body = body[:body.index("\n}\n")]
    for line in ("for (int kc = 1; kc <= C && kc <= max_kc; ++kc) {",
                 "if (C % kc || (static_cast<int64_t>(kc) * HW * esize) % "
                 "WALK_VEC_BYTES) continue;",
                 "if (best && static_cast<int64_t>(C / kc) * G < "
                 "WALK_MIN_BLOCKS) break;",
                 "if (static_cast<int64_t>(ng) * kc * HW * esize >= "
                 "WALK_MIN_BLOCK_BYTES) break;",
                 "return best ? best : 1;"):
        assert line in body
    src = open(os.path.join(ROOT, "incubator_mxnet_tpu_torch", "csrc",
                            "bn_copy.cu")).read()
    assert "return walk_channels(C, HW, dtype == 0 ? 4 : 2, ng, G);" in src
    assert "kc = bn_copy_channels(dtype, G, C, HW, ng);" in src
    assert "grid(C / kc, G)" in src


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", _load("bn_kernel_bench_torch").SHAPES)
def test_k7_geometry_at_the_bn_shapes(shape, itemsize):
    """At the 9 ResNet-50 BN shapes the runs are whole 16-byte vectors that
    start on 16 bytes (no scalar element), every element is written once,
    and the grid fills the card; kc is the header note's."""
    n, c, h, w = shape
    ng = fused_bn.ghost_group(n, c, h, w, itemsize, 16)
    kc, flat, base, head, tail = _check_k7_geometry(shape, itemsize, ng)
    assert flat and np.all(head == 0) and np.all(tail == kc * h * w)
    assert (c // kc) * (n // ng) >= _walk_defines()["WALK_MIN_BLOCKS"]
    if itemsize == 2:
        assert kc == {112: 1, 56: 1, 28: 1, 14: 4,
                      7: 8 if c == 512 else 16}[h]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,ng,x_offset", [
    ((48, 3, 1, 5), 16, 0), ((6, 3, 5, 5), 3, 0), ((32, 64, 7, 7), 16, 0),
    ((4, 16, 1, 1), 1, 0), ((6, 3, 7, 2), 3, 0), ((32, 64, 7, 7), 16, 1),
    ((6, 3, 5, 5), 3, 3), ((16, 24, 3, 3), 8, 0), ((8, 40, 5, 1), 4, 0),
    ((6, 7, 3, 3), 3, 0)])
def test_k7_geometry_at_odd_shapes(shape, ng, x_offset, itemsize):
    """Runs that are not whole vectors, or start off 16 bytes, or an x off
    y's 16-byte grid, on either path of copy_runs: each element is
    still written once (counted one by one here)."""
    kc, _, base, head, tail = _check_k7_geometry(shape, itemsize, ng,
                                                 x_offset)
    n, c, h, w = shape
    run = kc * h * w
    hits = np.zeros(n * c * h * w, dtype=np.int64)
    vec = _walk_defines()["WALK_VEC_BYTES"] // itemsize
    for b, hd, tl in zip(base, head, tail):
        hits[b:b + hd] += 1                       # the scalar head
        hits[b + hd:b + tl] += 1                  # whole vectors
        hits[b + tl:b + run] += 1                 # the scalar tail
        assert (tl - hd) % vec == 0
    assert np.all(hits == 1)


# ---------------------------------------------------------------------------
# K1/K2's geometry (csrc/ghost_bn.cu): the same walk, per-channel sums, the
# slice staged once over a cluster of CTAs
# ---------------------------------------------------------------------------

GBN = os.path.join(ROOT, "incubator_mxnet_tpu_torch", "csrc", "ghost_bn.cu")


def _gbn_defines():
    out = dict(_walk_defines())
    with open(GBN) as f:
        for name, expr in re.findall(r"^#define (GBN_\w+) (.+)$", f.read(),
                                     re.M):
            out[name] = int(eval(expr, {}, dict(out)))
    return out


def _gbn_plan(c, hw, itemsize, ng, groups, tensors, share=None):
    """The test's model of ``plan`` in ghost_bn.cu: ``(kc, cs, nbuf)``,
    nbuf 0 for the two-read form.  kc is walk_channels' capped at
    GBN_MAX_KC; a slice of ``tensors``
    staged tensors whose runs are whole 16-byte vectors is split over the
    smallest power-of-two cluster cs (dividing ng, at most
    GBN_MAX_CLUSTER) that brings a CTA's share to GBN_SHARE_BYTES (or
    ``share``), staged when that share is at most GBN_MAX_SHARE, in two
    buffers when it is at most GBN_DOUBLE_BYTES."""
    d = _gbn_defines()
    share = share or d["GBN_SHARE_BYTES"]
    kc = _walk_channels(c, hw, itemsize, ng, groups, d["GBN_MAX_KC"])
    run_bytes = kc * hw * itemsize
    if run_bytes % d["WALK_VEC_BYTES"]:
        return kc, 1, 0
    whole = ng * run_bytes * tensors
    cs = 1
    while whole // cs > share and 2 * cs <= d["GBN_MAX_CLUSTER"] \
            and ng % (2 * cs) == 0:
        cs *= 2
    if whole // cs > d["GBN_MAX_SHARE"]:
        return kc, 1, 0
    return kc, cs, 2 if whole // cs <= d["GBN_DOUBLE_BYTES"] else 1


def _span(i0, v, hw, kc):
    """``Span``: the channels of the v elements of a unit at offset i0 of
    a run: c0 = i0 / HW for the first nb, c0 + 1 for the rest, or each
    its own where HW < v (a unit then spans more than two)."""
    c0 = 0 if kc == 1 else i0 // hw
    nb = v if kc == 1 else (c0 + 1) * hw - i0
    few = kc == 1 or hw >= v
    return [c0 if e < nb else (c0 + 1 if few else (i0 + e) // hw)
            for e in range(v)]


def test_gbn_constants_and_plan_match_the_source():
    """The header's plan is the one modelled here: K1 stages x (+ r), K2
    gy and x (+ gy2, + y); the grid is a slice a CTA (times the cluster),
    capped at what fits on the card at once in the staged form."""
    d = _gbn_defines()
    assert (d["GBN_MAX_KC"], d["GBN_MAX_CLUSTER"], d["GBN_SHARE_BYTES"],
            d["GBN_DOUBLE_BYTES"], d["GBN_MAX_SHARE"], d["GBN_THREADS"]) == \
        (64, 8, 100 * 1024, 56 * 1024, 224 * 1024, 256)
    src = open(GBN).read()
    body = src[src.index("Plan plan(int esize"):]
    body = body[:body.index("\n}\n")]
    for line in ("walk_channels(C, HW, esize, ng, G, GBN_MAX_KC)",
                 "if (!aligned || run_bytes % WALK_VEC_BYTES) return pl;",
                 "while (slice / cs > GBN_SHARE_BYTES && 2 * cs <= "
                 "GBN_MAX_CLUSTER && ng % (2 * cs) == 0)",
                 "if (slice / cs > GBN_MAX_SHARE) return pl;",
                 "pl.nbuf = pl.share <= GBN_DOUBLE_BYTES ? 2 : 1;"):
        assert line in body, line
    assert "plan(sizeof(T), r == nullptr ? 1 : 2, G, C, HW, ng," in src
    assert "plan(sizeof(T), 2 + dual + res, G, C, HW, ng, aligned)" in src
    assert "const int slices = (C / pl.kc) * G;" in src
    assert "cfg.gridDim = dim3(slices * pl.cs);" in src
    assert "dim3((resident < slices ? resident : slices) * pl.cs)" in src


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", _load("bn_kernel_bench_torch").SHAPES)
def test_gbn_geometry_at_the_bn_shapes(shape, itemsize):
    """At the 9 ResNet-50 BN shapes every form (1-4 staged tensors) stages
    its slice (one read), a CTA's buffers fit its shared memory, the
    cluster's CTAs hold whole runs that tile the group's ng, and kc is
    K7's; in bf16 the stem and 56x56 take the clusters the source's note
    gives."""
    n, c, h, w = shape
    d = _gbn_defines()
    ng = fused_bn.ghost_group(n, c, h, w, itemsize, 16)
    plans = [_gbn_plan(c, h * w, itemsize, ng, n // ng, t)
             for t in (1, 2, 3, 4)]
    for t, (kc, cs, nbuf) in zip((1, 2, 3, 4), plans):
        assert nbuf and ng % cs == 0 and cs <= d["GBN_MAX_CLUSTER"]
        assert kc == _walk_channels(c, h * w, itemsize, ng, n // ng)
        assert nbuf * (ng * kc * h * w * itemsize * t // cs) <= \
            d["GBN_MAX_SHARE"]
        ranks = [range(r * (ng // cs), (r + 1) * (ng // cs))
                 for r in range(cs)]
        assert sorted(p for r in ranks for p in r) == list(range(ng))
    if itemsize == 2 and (h, c) in ((112, 64), (56, 64), (56, 256)):
        want = {(112, 64): (4, 8, 8, 8), (56, 64): (1, 2, 4, 4),
                (56, 256): (1, 2, 4, 4)}[(h, c)]
        assert tuple(p[1] for p in plans) == want


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("c,hw", [(64, 49), (256, 49), (1024, 196),
                                  (256, 196), (64, 784), (16, 5)])
def test_gbn_channel_of_each_element(c, hw, itemsize):
    """The write pass's channel of each element of a run (Span over
    16-byte units) is its index / HW, also where a unit straddles two
    channels (HW 49 and 196 in bf16) or more (HW 5 in bf16); the sums'
    pass reads channel by channel in 16-byte units where HW is whole
    units, in 8-byte units where it is whole such units, else element by
    element, and covers each element of each channel once."""
    vec = _walk_defines()["WALK_VEC_BYTES"] // itemsize
    kc, _, nbuf = _gbn_plan(c, hw, itemsize, 16, 16, 2)
    assert nbuf
    run = kc * hw
    got = [ch for i0 in range(0, run, vec) for ch in _span(i0, vec, hw, kc)]
    assert got == [i // hw for i in range(run)]
    straddle = any(i0 // hw != (i0 + vec - 1) // hw
                   for i0 in range(0, run, vec))
    assert straddle == (kc > 1 and hw % vec != 0)
    v = vec if hw % vec == 0 else vec // 2 if hw % (vec // 2) == 0 else 1
    threads = _walk_defines()["WALK_THREADS"]
    nl = 4
    hits = np.zeros((nl, run), dtype=np.int64)
    for ch in range(kc):
        cover = _run_iter_cover(nl, hw // v, threads, 1)
        assert np.all(cover == 1)
        for j in range(v):
            hits[:, ch * hw + np.arange(hw // v) * v + j] += cover
    assert np.all(hits == 1)


def _simulate_fwd(x, gamma, beta, ng, itemsize, share, eps=1e-5):
    """K1's staged arithmetic over its geometry in numpy (f32 sums): for
    each block, each CTA of its cluster sums its runs channel by channel,
    the totals are the CTAs' partials added in rank order, and the write
    pass maps each element of each 16-byte unit to its channel with
    Span.  Returns (y, mean, var, writes a element)."""
    n, c, h, w = x.shape
    hw, groups = h * w, n // ng
    kc, cs, nbuf = _gbn_plan(c, hw, itemsize, ng, groups, 1, share)
    assert nbuf
    vec = _walk_defines()["WALK_VEC_BYTES"] // itemsize
    nl, run = ng // cs, kc * hw
    flat = x.reshape(groups, ng, c // kc, run)
    y = np.full_like(flat, np.nan)
    hits = np.zeros(flat.shape, dtype=np.int64)
    mean = np.zeros((groups, c), np.float32)
    var = np.zeros((groups, c), np.float32)
    chan = np.array([ch for i0 in range(0, run, vec)
                     for ch in _span(i0, vec, hw, kc)])
    cnt = np.float32(ng * hw)
    for g in range(groups):
        for cb in range(c // kc):
            parts = []
            for r in range(cs):
                share_x = flat[g, r * nl:(r + 1) * nl, cb]      # (nl, run)
                per = share_x.reshape(nl, kc, hw)
                parts.append((per.sum(axis=(0, 2), dtype=np.float32),
                              (per * per).sum(axis=(0, 2), dtype=np.float32)))
            s = np.zeros(kc, np.float32)
            ss = np.zeros(kc, np.float32)
            for a, b in parts:                       # rank order
                s, ss = s + a, ss + b
            m = s / cnt
            v = np.maximum(ss / cnt - m * m, 0).astype(np.float32)
            rstd = 1 / np.sqrt(v + np.float32(eps))
            gm = gamma[cb * kc:(cb + 1) * kc]
            scale = gm * rstd
            shift = beta[cb * kc:(cb + 1) * kc] - m * gm * rstd
            mean[g, cb * kc:(cb + 1) * kc] = m
            var[g, cb * kc:(cb + 1) * kc] = v
            for r in range(cs):
                sl = slice(r * nl, (r + 1) * nl)
                y[g, sl, cb] = flat[g, sl, cb] * scale[chan] + shift[chan]
                hits[g, sl, cb] += 1
    return (np.maximum(y, 0).reshape(x.shape), mean, var,
            hits.reshape(x.shape))


@pytest.mark.parametrize("shape,itemsize,share,cs", [
    ((32, 64, 7, 7), 2, 4096, 4),       # kc 8: 16-byte units straddle
    ((32, 32, 14, 14), 2, 8192, 2),     # kc 4 at HW 196
    ((32, 16, 12, 12), 4, 2048, 8),     # kc 1, the stem's form
])
def test_gbn_simulated_forward_matches_plain(shape, itemsize, share, cs):
    """K1's geometry at small shapes, with a small share so that the slice
    splits over a cluster as the stem's does: every element is written
    once, and the simulated forward agrees with the plain version within
    1e-5 (f32 sums in another order)."""
    n, c, h, w = shape
    rng = np.random.RandomState(0)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.2).astype(np.float32)
    assert _gbn_plan(c, h * w, itemsize, 16, n // 16, 1, share)[1] == cs
    y, m, v, hits = _simulate_fwd(x, gamma, beta, 16, itemsize, share)
    assert np.all(hits == 1)
    yp, mp, vp = fused_bn._gbn_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        None, 1e-5, "relu", 16)
    np.testing.assert_allclose(y, yp.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m, mp.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v, vp.numpy(), rtol=1e-5, atol=1e-6)
