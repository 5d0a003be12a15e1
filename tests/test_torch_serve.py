"""The port's serving stack (``incubator_mxnet_tpu_torch/serve``) against
the JAX package's (``incubator_mxnet_tpu/serve``), on the CPU.

- The engine on a conv/BN/max-pool net at 16 px (random running stats)
  and on an MLP, weights carried across by name, buckets (2, 8), against
  the reference's ``ServeEngine(..., lint="off")`` on the same numpy
  inputs: outputs within ``TOL`` (f32: max abs error over the
  reference's largest magnitude, at least 1), the counters and the
  parameter signature equal.  ``lint="off"``: the reference's default
  lint walks jaxprs with ``jax.core.ClosedJaxpr``, which this JAX lacks.
- ``bucket_for`` and the validation errors (the reference's error
  classes); a row of a bucket does not depend on its batch-mates (bit
  for bit), and a padded bucket agrees with the unpadded forward within
  ``TOL`` (oneDNN may pick another algorithm at another batch size);
  no program built after warmup, a miss counted and warned (GL005);
  chunking over the largest bucket; ``shadow_infer``.
- ``update_params``: commit, the NaN rollback, the GL011 drift refusal
  and ``canary_tol``, each as the reference decides it, the served
  outputs after a commit within ``TOL`` of the reference's.
- The bf16 tier against the reference's, within ``BF16_TOL``.
- The batcher cases of ``tests/test_serve.py``: deadline flush, size
  flush, malformed requests failing alone, backpressure, slow client,
  concurrent shutdown, batch failure, the loadtest report's fields.
- ``CachedDecoder``'s logits against the reference's decoder step for
  step (``DEC_TOL``), its seq buckets and refusals, and the ring
  wraparound against the reference and against full recompute over the
  sliding window.

Every wait is bounded and every batcher closed in ``finally``.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.gluon import block as jblock
from incubator_mxnet_tpu.gluon import nn as jnn

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.gluon import block as tblock
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
from incubator_mxnet_tpu_torch.serve import (Backpressure, CachedDecoder,
                                             ContinuousBatcher, LintError,
                                             LoadReport, RequestError,
                                             ServeEngine, SwapRejected,
                                             TinyDecoderLM, poisson_loadtest)

SAMPLE = (16,)
IMG = (3, 16, 16)
#: f32: max abs error over the reference's largest magnitude (at least 1)
TOL = 1e-5
#: the bf16 tier (both packages round the same weights to bf16)
BF16_TOL = 2e-2
#: the decoder's logits, f32
DEC_TOL = 1e-5


def _fresh_names():
    jblock._BlockScope._state.counter = {}
    tblock._BlockScope._state.counter = {}


def _layers(nn, kind):
    if kind == "mlp":
        return [nn.Dense(32, activation="relu"), nn.Dense(10)]
    return [nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.MaxPool2D(2), nn.GlobalAvgPool2D(),
            nn.Flatten(), nn.Dense(6)]


def _pair(kind):
    """(reference net, port net) of ``kind`` with equal weights; the BN's
    running stats random, so inference-mode BN is not the identity."""
    shape = (2,) + (SAMPLE if kind == "mlp" else IMG)
    _fresh_names()
    jmx.random.seed(7)
    jnet = jnn.HybridSequential()
    jnet.add(*_layers(jnn, kind))
    jnet.initialize(init=jmx.init.Xavier())
    jnet(jnd.ones(shape))
    rs = np.random.RandomState(1)
    arrays = {}
    for k, p in jnet.collect_params().items():
        a = p.data().asnumpy()
        if "running_mean" in k:
            a = rs.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        elif "running_var" in k:
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        p.set_data(jnd.array(a))
        arrays[k] = a
    _fresh_names()
    tnet = tnn.HybridSequential()
    with context.device_scope("cpu"):
        tnet.add(*_layers(tnn, kind))
    tnet.initialize(init=tmx.init.Xavier())
    tnet.shape_init(shape)
    convert.params_from_gluon(tnet, arrays)
    return jnet, tnet


@pytest.fixture(scope="module")
def mlp():
    return _pair("mlp")


@pytest.fixture(scope="module")
def cnn():
    return _pair("cnn")


def _sample(kind):
    return np.zeros(SAMPLE if kind == "mlp" else IMG, np.float32)


def _x(n, kind="mlp", seed=0):
    shape = SAMPLE if kind == "mlp" else IMG
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


def _ref_engine(jnet, kind="mlp", **kw):
    eng = jserve.ServeEngine(jnet, lint="off", **kw)
    eng.warmup(_sample(kind))
    return eng


def _engine(tnet, kind="mlp", **kw):
    eng = ServeEngine(tnet, device="cpu", **kw)
    eng.warmup(_sample(kind))
    return eng


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# engine against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_engine_matches_reference(kind, request):
    jnet, tnet = request.getfixturevalue(kind)
    ref = _ref_engine(jnet, kind, buckets=(2, 8))
    eng = _engine(tnet, kind, buckets=(2, 8))
    assert [(s, d) for _n, s, d in eng.param_signature] == \
        [(s, d) for _n, s, d in ref.param_signature]
    assert [n for n, _s, _d in eng.param_signature] == \
        [n for n, _s, _d in ref.param_signature]
    for n, seed in ((1, 1), (2, 2), (5, 3), (8, 4), (11, 5)):
        x = _x(n, kind, seed)
        _close(_np(eng.infer(x)), np.asarray(ref.infer(x)))
    for attr in ("infer_calls", "rows_served", "padded_rows",
                 "recompile_count", "params_version",
                 "last_version_served"):
        assert getattr(eng, attr) == getattr(ref, attr), attr


def test_bucket_selection():
    net = tnn.Dense(4, in_units=SAMPLE[0], device="cpu")
    eng = ServeEngine(net, buckets=(4, 16, 8), device="cpu")
    assert eng.buckets == (4, 8, 16)
    assert eng.max_bucket == 16
    ref = jserve.ServeEngine(jnn.Dense(4), buckets=(4, 16, 8), lint="off")
    ns = (1, 4, 5, 8, 9, 16, 40)
    assert [eng.bucket_for(n) for n in ns] == [ref.bucket_for(n) for n in ns]
    assert [eng.bucket_for(n) for n in ns] == [4, 4, 8, 8, 16, 16, 16]


_BAD_BUILDS = {
    "nonpositive": (dict(buckets=(0, 4)), "positive"),
    "duplicate": (dict(buckets=(4, 4)), "duplicate"),
}

_BAD_CALLS = {
    "shape": (lambda e: e.infer(np.zeros((2, 7), np.float32)),
              "engine serves"),
    "dtype": (lambda e: e.infer(np.zeros((2,) + SAMPLE, np.float64)),
              "dtype"),
    "empty": (lambda e: e.infer(np.zeros((0,) + SAMPLE, np.float32)),
              "empty"),
}


@pytest.mark.parametrize("case", sorted(_BAD_BUILDS))
def test_engine_build_validation(case, mlp):
    kw, match = _BAD_BUILDS[case]
    jnet, tnet = mlp
    with pytest.raises(ValueError, match=match):
        jserve.ServeEngine(jnet, lint="off", **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(tnet, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(_BAD_CALLS))
def test_engine_call_validation(case, mlp):
    call, match = _BAD_CALLS[case]
    jnet, tnet = mlp
    with pytest.raises(ValueError, match=match):
        call(_ref_engine(jnet, buckets=(4,)))
    with pytest.raises(ValueError, match=match):
        call(_engine(tnet, buckets=(4,)))


def test_engine_refuses_before_warmup_and_int8(mlp):
    _, tnet = mlp
    with pytest.raises(RuntimeError, match="warmup"):
        ServeEngine(tnet, buckets=(4,), device="cpu").infer(
            np.zeros((1,) + SAMPLE, np.float32))
    with pytest.raises(RuntimeError, match="warmup"):
        ServeEngine(tnet, buckets=(4,), device="cpu").update_params([])
    # dtype="int8" is the quantized tier now; a non-float compute dtype
    # is still refused
    ServeEngine(tnet, buckets=(4,), dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="float dtype"):
        ServeEngine(tnet, buckets=(4,), dtype="int32", device="cpu")
    lazy = tnn.Dense(4, device="cpu")
    lazy.initialize()
    with pytest.raises(RuntimeError, match="initialize"):
        ServeEngine(lazy, buckets=(4,), device="cpu").warmup(
            np.zeros(SAMPLE, np.float32))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_row_independent_and_padded_close_to_unpadded(kind, request):
    """A row of a bucket is bit-identical whatever its batch-mates; the
    padded bucket agrees with the unpadded forward (its own bucket)
    within TOL."""
    _, tnet = request.getfixturevalue(kind)
    eng = _engine(tnet, kind, buckets=(8,))
    x = _x(5, kind, 0)
    padded = _np(eng.infer(x))
    other = np.concatenate([x[:1], _x(6, kind, 9)])
    np.testing.assert_array_equal(_np(eng.infer(other))[0], padded[0])
    for n in (5, 1):
        exact = _engine(tnet, kind, buckets=(n,))
        _close(padded[:n], _np(exact.infer(x[:n])))
    assert eng.padded_rows == 3 + 1


def test_no_capture_after_warmup_and_a_miss_counts(mlp):
    import warnings

    _, tnet = mlp
    eng = _engine(tnet, buckets=(2, 4))
    rs = np.random.RandomState(2)
    for n in (1, 2, 3, 4, 2, 1):
        eng.infer(rs.rand(n, *SAMPLE).astype(np.float32))
    assert eng.recompile_count == 0 and eng.padded_rows > 0
    part = ServeEngine(tnet, buckets=(2, 4), device="cpu")
    part.warmup(np.zeros(SAMPLE, np.float32), buckets=(4,))
    with pytest.warns(UserWarning, match="GL005"):
        part.infer(rs.rand(2, *SAMPLE).astype(np.float32))
    assert part.recompile_count == 1
    staged = ServeEngine(tnet, buckets=(2, 4), device="cpu")
    staged.warmup(np.zeros(SAMPLE, np.float32), buckets=(2,))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        staged.warmup(np.zeros(SAMPLE, np.float32), buckets=(4,))
        staged.infer(np.zeros((3,) + SAMPLE, np.float32))
    assert staged.recompile_count == 0
    assert not any("GL005" in str(w.message) for w in caught)


def test_chunking_over_max_bucket(mlp):
    jnet, tnet = mlp
    eng = _engine(tnet, buckets=(4,))
    x = _x(10, seed=3)
    out = _np(eng.infer(x))
    assert out.shape == (10, 10)
    np.testing.assert_array_equal(out[:4], _np(eng.infer(x[:4])))
    np.testing.assert_array_equal(out[8:], _np(eng.infer(x[8:])))
    _close(out, np.asarray(_ref_engine(jnet, buckets=(4,)).infer(x)))
    assert eng.infer_calls == 3 and eng.padded_rows == 2 + 2


def test_shadow_infer_matches_reference(mlp):
    jnet, tnet = mlp
    ref = _ref_engine(jnet, buckets=(4, 8))
    eng = _engine(tnet, buckets=(4, 8))
    x = _x(3, seed=4)
    cand = [np.array(p.data().asnumpy()) * 0.5
            for p in jnet.collect_params().values()]
    _close(_np(eng.shadow_infer(x)), np.asarray(ref.shadow_infer(x)))
    _close(_np(eng.shadow_infer(x, candidate=cand)),
           np.asarray(ref.shadow_infer(x, candidate=cand)))
    live = _np(eng.infer(x))
    _close(live, np.asarray(ref.infer(x)))
    assert eng.params_version == 1 and eng.infer_calls == 1
    with pytest.raises(LintError, match="GL011"):
        eng.shadow_infer(x, candidate=cand[:-1])


# ---------------------------------------------------------------------------
# canaried hot swap against the reference
# ---------------------------------------------------------------------------

def _swap_outcome(eng, cand, **kw):
    from incubator_mxnet_tpu.serve.resilience import \
        SwapRejected as JSwapRejected

    try:
        return eng.update_params(cand, **kw)
    except (SwapRejected, JSwapRejected) as e:
        return "rejected: " + e.reason.split(" (")[0].split(" exceeds")[0]
    except ValueError as e:   # LintError of either package
        return type(e).__name__ + ("/GL011" if "GL011" in str(e) else "")


def _candidates(jnet):
    good = [np.array(p.data().asnumpy()) for p in jnet.collect_params().values()]
    nan = [a.copy() for a in good]
    nan[0].reshape(-1)[0] = np.nan
    return {
        "commit": (dict(), [a * 1.5 for a in good]),
        "nan": (dict(), nan),
        "drift_tol": (dict(canary=_x(2, seed=7), canary_tol=0.5),
                      [a * 100.0 for a in good]),
        "drift_no_tol": (dict(canary=_x(2, seed=7)),
                         [a * 100.0 for a in good]),
        "shape": (dict(), [np.zeros((3, 3), np.float32)] + good[1:]),
        "dtype": (dict(), [good[0].astype(np.float64)] + good[1:]),
        "short": (dict(), good[:-1]),
    }


@pytest.mark.parametrize("case", ["commit", "nan", "drift_tol",
                                  "drift_no_tol", "shape", "dtype", "short"])
def test_update_params_matches_reference(case, mlp):
    jnet, tnet = mlp
    kw, cand = _candidates(jnet)[case]
    ref = _ref_engine(jnet, buckets=(4, 8))
    eng = _engine(tnet, buckets=(4, 8))
    x = _x(5, seed=6)
    before = _np(eng.infer(x))
    got = _swap_outcome(eng, cand, **kw)
    want = _swap_outcome(ref, cand, **kw)
    assert got == want, (got, want)
    for attr in ("params_version", "swap_count", "rollback_count"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    assert [e["ok"] for e in eng.swap_log] == [e["ok"] for e in ref.swap_log]
    after = _np(eng.infer(x))
    _close(after, np.asarray(ref.infer(x)))
    if not isinstance(got, int):   # refused: the incumbent, bit for bit
        np.testing.assert_array_equal(after, before)
    assert eng.recompile_count == 0 and eng.last_version_served == \
        eng.params_version


def test_update_params_dict_and_missing_names(mlp):
    _, tnet = mlp
    eng = _engine(tnet, buckets=(4,))
    good = [p.data().asnumpy() for p in tnet.collect_params().values()]
    named = {n: v for (n, _s, _d), v in zip(eng.param_signature, good)}
    foreign = dict(named)
    foreign["not_a_param"] = foreign.pop(next(iter(foreign)))
    with pytest.raises(LintError, match="GL011"):
        eng.update_params(foreign)
    blank = dict(named)
    blank[next(iter(blank))] = None
    with pytest.raises(LintError, match="GL011"):
        eng.update_params(blank)
    assert eng.params_version == 1
    assert eng.update_params(named) == 2


def test_bf16_tier_matches_reference(cnn):
    jnet, tnet = cnn
    ref = _ref_engine(jnet, "cnn", buckets=(8,), dtype="bfloat16")
    eng = _engine(tnet, "cnn", buckets=(8,), dtype="bfloat16")
    x = _x(6, "cnn", 5)
    got = eng.infer(x)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.infer(x)).astype(np.float32)
    _close(_np(got), want, BF16_TOL)
    f32 = _np(_engine(tnet, "cnn", buckets=(8,)).infer(x))
    _close(_np(got), f32, BF16_TOL)
    assert all(t.dtype == torch.bfloat16 for t in eng._live[1])
    assert eng.update_params([p.data().asnumpy() for p in
                              tnet.collect_params().values()]) == 2


# ---------------------------------------------------------------------------
# continuous batcher (tests/test_serve.py's cases, on the port's engine)
# ---------------------------------------------------------------------------

def test_deadline_flush_fires_without_full_batch(mlp):
    eng = _engine(mlp[1], buckets=(8,))
    b = ContinuousBatcher(eng, max_delay=0.05)
    try:
        x = _x(3, seed=6)
        t0 = time.monotonic()
        futs = [b.submit(x[i]) for i in range(3)]
        rows = [np.asarray(f.result(timeout=5)) for f in futs]
        assert time.monotonic() - t0 < 3.0
        assert b.stats.flush_deadline >= 1 and b.stats.flush_full == 0
        np.testing.assert_array_equal(np.stack(rows), _np(eng.infer(x)))
        assert sum(k * v for k, v in b.stats.occupancy.items()) == 3
    finally:
        b.close()


def test_size_flush_fires_before_deadline(mlp):
    eng = _engine(mlp[1], buckets=(4,))
    b = ContinuousBatcher(eng, max_batch=4, max_delay=5.0)
    try:
        x = _x(4, seed=7)
        t0 = time.monotonic()
        for f in [b.submit(x[i]) for i in range(4)]:
            f.result(timeout=5)
        assert time.monotonic() - t0 < 4.0
        assert b.stats.flush_full >= 1
    finally:
        b.close()


def test_malformed_requests_fail_alone_batch_survives(mlp):
    eng = _engine(mlp[1], buckets=(8,))
    b = ContinuousBatcher(eng, max_delay=0.05)
    try:
        x = _x(2, seed=8)
        good1 = b.submit(x[0])
        bad = [b.submit(fi.malformed_request(SAMPLE, kind=k))
               for k in ("rank", "shape", "dtype", "unconvertible")]
        good2 = b.submit(x[1])
        for f in bad:
            with pytest.raises(RequestError, match="malformed request"):
                f.result(timeout=5)
        ref = _np(eng.infer(x))
        np.testing.assert_array_equal(good1.result(timeout=5), ref[0])
        np.testing.assert_array_equal(good2.result(timeout=5), ref[1])
        assert b.stats.rejected == 4
        np.testing.assert_array_equal(b.submit(x[0]).result(timeout=5),
                                      ref[0])
    finally:
        b.close()


def test_backpressure_bounded_queue_sheds(mlp):
    eng = _engine(mlp[1], buckets=(4,))
    real_infer, gate = eng.infer, threading.Event()

    def slow_infer(x):
        gate.wait(timeout=5)
        return real_infer(x)

    eng.infer = slow_infer
    b = ContinuousBatcher(eng, max_delay=0.01, max_queue=4)
    futs = []
    try:
        x = np.zeros(SAMPLE, np.float32)
        futs, shed = fi.burst_arrivals(b, [x] * 32)
        assert shed > 0 and len(futs) + shed == 32
        with pytest.raises(Backpressure):
            while True:
                b.submit(x, block=False)
    finally:
        gate.set()
        b.close()
    assert all(f.done() for f in futs)


def test_slow_client_is_deadline_bounded(mlp):
    eng = _engine(mlp[1], buckets=(8,))
    b = ContinuousBatcher(eng, max_delay=0.03)
    try:
        x = _x(3, seed=9)
        with fi.slow_client(0.05) as stats:
            futs = [b.submit(x[i]) for i in range(3)]
        assert stats.slowed == 3
        rows = [np.asarray(f.result(timeout=5)) for f in futs]
        np.testing.assert_array_equal(np.stack(rows), _np(eng.infer(x)))
        assert b.stats.flush_deadline >= 1
    finally:
        b.close()


def test_concurrent_submit_shutdown_joins_cleanly(mlp):
    eng = _engine(mlp[1], buckets=(8,))
    b = ContinuousBatcher(eng, max_delay=0.01, max_queue=64)
    x = np.zeros(SAMPLE, np.float32)
    futs, stop = [], threading.Event()

    def pound():
        while not stop.is_set():
            try:
                futs.append(b.submit(x, block=False))
            except (Backpressure, RuntimeError):
                time.sleep(0.001)

    threads = [threading.Thread(target=pound) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        b.close(join_timeout=5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        b.close(join_timeout=5)
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(x)
    for f in futs:
        assert f.done() or f.exception(timeout=1) is not None


def test_batch_failure_fails_batch_not_loop(mlp):
    eng = _engine(mlp[1], buckets=(4,))
    real_infer = eng.infer
    boom = {"n": 0}

    def flaky(xv):
        if boom["n"] == 0:
            boom["n"] += 1
            raise RuntimeError("injected engine failure")
        return real_infer(xv)

    eng.infer = flaky
    b = ContinuousBatcher(eng, max_delay=0.02)
    try:
        x = np.zeros(SAMPLE, np.float32)
        f1 = b.submit(x)
        with pytest.raises(RuntimeError, match="injected engine failure"):
            f1.result(timeout=5)
        assert b.submit(x).result(timeout=5).shape == (10,)
        assert b.stats.failed == 1
    finally:
        b.close()


def test_poisson_loadtest_report(mlp):
    assert [f.name for f in dataclasses.fields(LoadReport)] == \
        [f.name for f in dataclasses.fields(jserve.LoadReport)]
    eng = _engine(mlp[1], buckets=(4, 8))
    b = ContinuousBatcher(eng, max_delay=0.01)
    try:
        x = _x(8, seed=10)
        rep = poisson_loadtest(b, lambda i, rng: x[i % 8], qps=800,
                               n_requests=60, seed=3)
        assert rep.ok == 60 and rep.errors == 0 and rep.hung == 0
        assert rep.recompiles == 0
        assert rep.qps_sustained > 0
        assert rep.p50_ms <= rep.p95_ms <= rep.p99_ms
        assert sum(k * v for k, v in rep.occupancy.items()) == 60
        assert rep.versions == {"primary:v1": 60}
        json.dumps(rep.to_dict())
        assert rep.format().startswith("loadtest: 60 req in ")
    finally:
        b.close()
    # the same report fields format as the reference's formats them
    kw = dict(n_requests=3, ok=2, errors=1, expired=1, occupancy={1: 2},
              versions={"primary:v1": 2}, rollbacks=1)
    assert LoadReport(**kw).format() == jserve.LoadReport(**kw).format()
    assert LoadReport(**kw).objective() == jserve.LoadReport(**kw).objective()


# ---------------------------------------------------------------------------
# the decode cache against the reference's
# ---------------------------------------------------------------------------

def _lm_pair(seed, **kw):
    import jax

    jlm = jserve.TinyDecoderLM(**kw)
    jparams = jlm.init(jax.random.PRNGKey(seed))
    tlm = TinyDecoderLM(**kw)
    return jlm, jparams, tlm, convert.decoder_params_from_jax(
        tlm, jparams, device="cpu")


def _decode(dec, prompt, steps, feed=None, max_new=None):
    """Prompt logits and ``steps`` greedy (or ``feed``) step logits."""
    logits0 = _np(dec.start(prompt, max_new=steps if max_new is None
                            else max_new))
    nxt = np.argmax(logits0[:, -1], -1).astype(np.int32)
    out = []
    for i in range(steps):
        tok = nxt if feed is None else feed[:, i]
        lg = _np(dec.step(tok))
        out.append(lg)
        nxt = np.argmax(lg, -1).astype(np.int32)
    return logits0, out


def test_cached_decode_matches_reference_step_for_step():
    import jax.numpy as jnp

    kw = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
              max_len=32)
    jlm, jparams, tlm, tparams = _lm_pair(0, **kw)
    prompt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ref = jserve.CachedDecoder(jlm, jparams, seq_buckets=(16,), lint="off")
    r0, rsteps = _decode(ref, prompt, 6)
    dec = CachedDecoder(tlm, tparams, seq_buckets=(16,), device="cpu")
    feed = np.stack([np.argmax(r0[:, -1], -1)]
                    + [np.argmax(s, -1) for s in rsteps[:-1]], 1)
    t0, tsteps = _decode(dec, prompt, 6, feed=feed.astype(np.int32))
    _close(t0, r0, DEC_TOL)
    for got, want in zip(tsteps, rsteps):
        _close(got, want, DEC_TOL)
    assert dec.compiles == ref.compiles == 2
    assert dec.pos == ref.pos == 10
    # and against the port's own full recompute
    seq = torch.from_numpy(np.concatenate([prompt, feed], 1))
    full = _np(tlm.apply_tokens(tparams, seq))
    for i, got in enumerate(tsteps):
        _close(got, full[:, 4 + i], DEC_TOL)
    _close(full, np.asarray(jlm.apply_tokens(jparams,
                                             jnp.asarray(seq.numpy()))),
           DEC_TOL)


def test_decode_seq_buckets_and_refusals():
    kw = dict(vocab=16, d_model=8, n_heads=2, n_layers=1, d_ff=16,
              max_len=32)
    _, _, tlm, tparams = _lm_pair(1, **kw)
    dec = CachedDecoder(tlm, tparams, seq_buckets=(8, 16), device="cpu")
    assert dec.seq_bucket_for(5) == 8
    assert dec.seq_bucket_for(9) == 16
    with pytest.raises(ValueError, match="seq bucket"):
        dec.seq_bucket_for(17)
    with pytest.raises(RuntimeError, match="start"):
        CachedDecoder(tlm, tparams, seq_buckets=(8,), device="cpu").step(
            np.zeros((1,), np.int32))
    with pytest.raises(ValueError, match="position table"):
        CachedDecoder(tlm, tparams, seq_buckets=(64,), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        CachedDecoder(tlm, tparams, seq_buckets=(0,), device="cpu")
    with pytest.raises(ValueError, match="exceeds cache"):
        from incubator_mxnet_tpu_torch.serve import init_cache
        tlm.prefill_into_cache(tparams, torch.zeros((1, 9), dtype=torch.long),
                               init_cache(1, 1, 8, 2, 4, device="cpu"))
    with pytest.raises(ValueError, match="keys"):
        convert.decoder_params_from_jax(tlm, {"embed": 0}, device="cpu")


def test_decode_ring_wraparound_is_sliding_window():
    kw = dict(vocab=16, d_model=8, n_heads=2, n_layers=1, d_ff=16,
              max_len=8)
    jlm, jparams, tlm, tparams = _lm_pair(2, **kw)
    prompt = np.array([[1, 2, 3]], np.int32)
    feed = np.array([[4, 9, 1, 7, 3, 3, 12, 5, 0]], np.int32)
    ref = jserve.CachedDecoder(jlm, jparams, seq_buckets=(8,), lint="off")
    _, rsteps = _decode(ref, prompt, 9, feed=feed, max_new=5)
    dec = CachedDecoder(tlm, tparams, seq_buckets=(8,), device="cpu")
    _, tsteps = _decode(dec, prompt, 9, feed=feed, max_new=5)
    for got, want in zip(tsteps, rsteps):
        assert np.isfinite(got).all()
        _close(got, want, DEC_TOL)
    assert dec.pos == 12 and dec.compiles == 2
    seq = torch.from_numpy(np.concatenate([prompt, feed], 1))
    full = _np(tlm.apply_tokens(tparams, seq, window=8))
    for i, got in enumerate(tsteps):
        _close(got, full[:, 3 + i], DEC_TOL)
    # a second start reuses the bucket's cache and program
    _, again = _decode(dec, prompt, 9, feed=feed, max_new=5)
    for a, b in zip(again, tsteps):
        np.testing.assert_array_equal(a, b)
    assert dec.compiles == 2
