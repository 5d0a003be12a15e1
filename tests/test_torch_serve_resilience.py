"""The port's serving resilience (``serve/resilience.py``, the batcher's
deadlines, watchdog, retry and breaker, the engine's canaried swap, and
the serving fault hooks of ``parallel/fault_injection.py``) against the
JAX package's, on the CPU.

- ``RetryPolicy`` and ``CircuitBreaker`` driven by the same calls on an
  injected clock: the same answers, states and transitions; the same
  validation errors; ``classify_future`` names the same outcomes.
- Each serving fault hook in a scenario whose result does not depend on
  thread timing (a wedged engine where timing would matter), run through
  both packages on an MLP with equal weights (the reference's engine at
  ``lint="off"``): the same outcomes for every future and the same
  ``ServeStats`` and engine counts.
- The swap storm under Poisson traffic, and a swap under live traffic:
  zero captures, no hung future, every row served by exactly one
  version; a stress test of threads calling the engine while swaps
  land, with a short switch interval: no lost count, each output its
  version's.
- ``parallel/aot.py``'s ``resolve_mode`` against the reference's.

Every wait is bounded and every batcher closed in ``finally``.
"""
import sys
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.gluon import block as jblock
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.parallel import aot as jaot
from incubator_mxnet_tpu.parallel import fault_injection as jfi
from incubator_mxnet_tpu.serve import batcher as jbatcher
from incubator_mxnet_tpu.serve import resilience as jres

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert, serve as tserve
from incubator_mxnet_tpu_torch.gluon import block as tblock
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.parallel import aot as taot
from incubator_mxnet_tpu_torch.parallel import fault_injection as tfi
from incubator_mxnet_tpu_torch.serve import batcher as tbatcher
from incubator_mxnet_tpu_torch.serve import resilience as tres

SAMPLE = (16,)


_NETS = {}


def _nets():
    """(reference MLP, port MLP) with equal weights, built at first use
    (not at import: every test worker imports every test file)."""
    if _NETS:
        return _NETS["j"], _NETS["t"]
    jblock._BlockScope._state.counter = {}
    jmx.random.seed(7)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(32, activation="relu"), jnn.Dense(10))
    jnet.initialize(init=jmx.init.Xavier())
    jnet(jnd.ones((2,) + SAMPLE))
    tblock._BlockScope._state.counter = {}
    tnet = tnn.HybridSequential()
    with context.device_scope("cpu"):
        tnet.add(tnn.Dense(32, activation="relu"), tnn.Dense(10))
    tnet.initialize(init=tmx.init.Xavier())
    tnet.shape_init((2,) + SAMPLE)
    convert.params_from_gluon(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    _NETS.update(j=jnet, t=tnet)
    return jnet, tnet


REF = SimpleNamespace(
    name="reference", serve=jserve, fi=jfi, res=jres, batcher=jbatcher,
    engine=lambda buckets=(4, 8): jserve.ServeEngine(
        _nets()[0], buckets=buckets, lint="off"))
PORT = SimpleNamespace(
    name="port", serve=tserve, fi=tfi, res=tres, batcher=tbatcher,
    engine=lambda buckets=(4, 8): tserve.ServeEngine(
        _nets()[1], buckets=buckets, device="cpu"))


def _warm(pkg, buckets=(4, 8)):
    eng = pkg.engine(buckets)
    eng.warmup(np.zeros(SAMPLE, np.float32))
    return eng


def _x(n, seed=0):
    return np.random.RandomState(seed).rand(n, *SAMPLE).astype(np.float32)


def _outcomes(futures, bound=10.0):
    """Each future's outcome by name (``ok`` or its exception's class),
    within one bound; a future still pending after it is ``hung``."""
    end = time.monotonic() + bound
    out = []
    for f in futures:
        try:
            f.result(timeout=max(0.0, end - time.monotonic()))
            out.append("ok")
        except Exception as e:  # noqa: BLE001 -- outcomes are the point
            out.append(type(e).__name__ if f.done() else "hung")
    return out


def _wedged(pkg):
    eng = _warm(pkg)
    gate = threading.Event()
    real = eng.infer

    def wedged(xv):
        gate.wait(timeout=10)
        return real(xv)

    eng.infer = wedged
    return eng, gate


def _settle(seconds):
    time.sleep(seconds)


# ---------------------------------------------------------------------------
# policy objects on an injected clock
# ---------------------------------------------------------------------------

def _breaker_script(res):
    brk = res.CircuitBreaker(failure_threshold=2, recovery_time=0.25)
    answers = []
    for kind, now in [("route", 0.0), ("fail", 0.1), ("route", 0.11),
                      ("fail", 0.2), ("route", 0.21), ("route", 0.3),
                      ("fail", 0.4), ("route", 0.5), ("route", 0.66),
                      ("fail", 0.7), ("route", 0.8), ("route", 0.96),
                      ("ok", 1.0), ("route", 1.1), ("fail", 1.2),
                      ("ok", 1.3)]:
        if kind == "route":
            answers.append(brk.route(now=now))
        elif kind == "fail":
            brk.record_failure(now=now)
        else:
            brk.record_success(now=now)
        answers.append((brk.state, brk.consecutive_failures,
                        brk.opened_at))
    return answers, brk.transitions


def test_circuit_breaker_transitions_match_reference():
    got, want = _breaker_script(tres), _breaker_script(jres)
    assert got == want
    assert [(a, b) for _t, a, b in got[1]] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "open"),
        ("open", "half_open"), ("half_open", "closed")]


@pytest.mark.parametrize("kw,match", [
    (dict(failure_threshold=0), "failure_threshold"),
    (dict(recovery_time=0), "recovery_time")])
def test_circuit_breaker_validation(kw, match):
    for res in (jres, tres):
        with pytest.raises(ValueError, match=match):
            res.CircuitBreaker(**kw)


def test_retry_policy_matches_reference():
    def answers(pkg):
        pol = pkg.res.RetryPolicy(max_retries=3, backoff=0.004,
                                  multiplier=3.0)
        excs = [RuntimeError("x"), OSError("y"), TimeoutError("z"),
                ValueError("malformed"), pkg.res.Shed("policy"),
                pkg.res.DeadlineExceeded("late"),
                pkg.batcher.Backpressure("full"), KeyError("k")]
        return ([pol.is_transient(e) for e in excs],
                [pol.delay(k) for k in range(4)], pol.max_retries)

    assert answers(PORT) == answers(REF)
    for res in (jres, tres):
        with pytest.raises(ValueError, match="max_retries"):
            res.RetryPolicy(max_retries=-1)
        with pytest.raises(ValueError, match="backoff"):
            res.RetryPolicy(backoff=-0.1)


def test_classify_future_matches_reference():
    def outcomes(res):
        fs = [Future() for _ in range(6)]
        fs[0].set_result(1)
        fs[1].set_exception(res.DeadlineExceeded("late"))
        fs[2].set_exception(res.Shed("open"))
        fs[3].set_exception(ValueError("bad"))
        fs[4].set_exception(TimeoutError("engine timed out"))
        return [res.classify_future(f, 0.01) for f in fs]

    assert outcomes(tres) == outcomes(jres) == \
        ["ok", "expired", "shed", "error", "error", "hung"]
    err = tres.SwapRejected("canary says no")
    assert err.reason == "canary says no" and str(err) == \
        str(jres.SwapRejected("canary says no"))


# ---------------------------------------------------------------------------
# the serving fault hooks, scenario by scenario, in both packages
# ---------------------------------------------------------------------------

def _malformed(pkg):
    eng = _warm(pkg)
    b = pkg.serve.ContinuousBatcher(eng, max_delay=0.05)
    try:
        x = _x(2, 8)
        futs = [b.submit(x[0])]
        futs += [b.submit(pkg.fi.malformed_request(SAMPLE, kind=k))
                 for k in ("rank", "shape", "dtype", "unconvertible")]
        futs.append(b.submit(x[1]))
        out = _outcomes(futs)
        again = _outcomes([b.submit(x[0])])
    finally:
        b.close()
    with pytest.raises(ValueError, match="kind"):
        pkg.fi.malformed_request(SAMPLE, kind="nope")
    return dict(out=out, again=again, rejected=b.stats.rejected,
                rows=eng.rows_served)


def _slow_client(pkg):
    eng = _warm(pkg, (8,))
    b = pkg.serve.ContinuousBatcher(eng, max_delay=0.03)
    try:
        x = _x(3, 9)
        with pkg.fi.slow_client(0.05, at=1) as st:
            futs = [b.submit(x[i]) for i in range(3)]
        out = _outcomes(futs)
    finally:
        b.close()
    return dict(out=out, seen=st.seen, slowed=st.slowed,
                full=b.stats.flush_full, rows=eng.rows_served)


def _burst(pkg):
    eng, gate = _wedged(pkg)
    b = pkg.serve.ContinuousBatcher(eng, max_delay=0.01, max_queue=4)
    try:
        futs, shed = pkg.fi.burst_arrivals(b, [_x(1)[0]] * 32)
        gate.set()
        out = _outcomes(futs)
    finally:
        gate.set()
        b.close()
    return dict(out=out, shed=shed, rows=eng.rows_served)


def _deadline_storm(pkg):
    eng, gate = _wedged(pkg)
    b = pkg.serve.ContinuousBatcher(eng, max_delay=0.5, grace=0.02)
    try:
        f0 = b.submit(_x(1)[0])   # wedges the worker
        _settle(0.05)
        futs, shed = pkg.fi.deadline_storm(b, [_x(1)[0]] * 12,
                                           deadline=1e-4)
        _settle(0.05)             # every storm deadline is past
        gate.set()
        out = _outcomes(futs + [f0])
    finally:
        gate.set()
        b.close()
    return dict(out=out, shed=shed, expired=b.stats.expired,
                rows=eng.rows_served)


def _kill_worker(pkg):
    eng = _warm(pkg)
    b = pkg.serve.ContinuousBatcher(eng, max_delay=0.01)
    try:
        with pkg.fi.kill_batcher_worker(at=0) as ks:
            first = _outcomes([b.submit(_x(1)[0])])
        later = _outcomes([b.submit(_x(1)[0])])
        deadline = time.monotonic() + 5
        while b.stats.respawns < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        b.close()
    return dict(first=first, later=later, killed=ks.killed,
                deaths=b.stats.worker_deaths, respawns=b.stats.respawns,
                failed=b.stats.failed)


def _failure_burst(pkg):
    eng = _warm(pkg)
    b = pkg.serve.ContinuousBatcher(
        eng, max_delay=0.005,
        retry=pkg.res.RetryPolicy(max_retries=2, backoff=0.001))
    try:
        with pkg.fi.engine_failure_burst(2) as st:
            absorbed = _outcomes([b.submit(_x(1)[0])])
    finally:
        b.close()
    brk = pkg.res.CircuitBreaker(failure_threshold=1, recovery_time=30.0)
    b2 = pkg.serve.ContinuousBatcher(eng, max_delay=0.005, breaker=brk)
    try:
        with pkg.fi.engine_failure_burst(5, engine=eng) as st2:
            tripped = _outcomes([b2.submit(_x(1)[0])])
            shed = _outcomes([b2.submit(_x(1)[0])])
            probe = _outcomes([b2.submit(_x(1)[0], priority=1)])
    finally:
        b2.close()
    return dict(absorbed=absorbed, retried=b.stats.retried,
                failed=st.failed, tripped=tripped, shed=shed, probe=probe,
                breaker_shed=b2.stats.breaker_shed, state=brk.state,
                failed2=st2.failed,
                transitions=[(a, c) for _t, a, c in brk.transitions])


def _nan_swap(pkg):
    eng = _warm(pkg)
    x = _x(2, 6)
    before = np.asarray(eng.infer(x))
    cand = pkg.fi.nan_params(eng)
    outcome = "committed"
    try:
        eng.update_params(cand)
    except pkg.res.SwapRejected as e:
        outcome = e.reason
    same = bool(np.array_equal(np.asarray(eng.infer(x)), before))
    with pytest.raises(ValueError, match="warmup"):
        pkg.fi.nan_params(pkg.engine())
    return dict(outcome=outcome, same=same, n=len(cand),
                nans=[int(np.isnan(a).sum()) for a in cand],
                version=eng.params_version, rollbacks=eng.rollback_count,
                swaps=eng.swap_count)


_SCENARIOS = {"malformed_request": _malformed, "slow_client": _slow_client,
              "burst_arrivals": _burst, "deadline_storm": _deadline_storm,
              "kill_batcher_worker": _kill_worker,
              "engine_failure_burst": _failure_burst,
              "nan_params": _nan_swap}


@pytest.mark.parametrize("hook", sorted(_SCENARIOS))
def test_fault_hook_matches_reference(hook):
    got = _SCENARIOS[hook](PORT)
    want = _SCENARIOS[hook](REF)
    assert got == want


def test_swap_storm_under_traffic_matches_reference():
    def storm(pkg):
        eng = _warm(pkg)
        b = pkg.serve.ContinuousBatcher(eng, max_delay=0.005)
        x = _x(8, 12)
        try:
            with pkg.fi.swap_storm(eng, n_swaps=4, interval=0.01,
                                   poison_at=2, seed=3) as st:
                rep = pkg.serve.poisson_loadtest(
                    b, lambda i, rng: x[i % 8], qps=400, n_requests=40,
                    seed=1, timeout=20.0)
        finally:
            b.close()
        return dict(attempted=st.attempted, committed=st.committed,
                    rejected=st.rejected, versions=st.versions,
                    poison=st.poison_rejected,
                    bitwise=st.incumbent_bitwise_ok, error=st.error,
                    ok=rep.ok, hung=rep.hung, recompiles=rep.recompiles,
                    unattributed=rep.unattributed,
                    version=eng.params_version)

    got, want = storm(PORT), storm(REF)
    assert got == want
    assert got["poison"] and got["bitwise"] and got["hung"] == 0
    assert got["committed"] == 3 and got["recompiles"] == 0


def test_hot_swap_under_live_traffic_exactly_one_version():
    eng = _warm(PORT)
    x = _x(4, 5)
    ref1 = np.asarray(eng.infer(x))
    b = tserve.ContinuousBatcher(eng, max_delay=0.005)
    stop, futs, lock = threading.Event(), [], threading.Lock()

    def pound():
        i = 0
        while not stop.is_set():
            try:
                f = b.submit(x[i % 4])
                with lock:
                    futs.append((i % 4, f))
            except (tserve.Backpressure, RuntimeError):
                pass
            i += 1
            time.sleep(0.001)

    def served(version):
        """Wait (bounded) until a request served by ``version`` is back."""
        end = time.monotonic() + 10
        while time.monotonic() < end:
            with lock:
                done = [f for _i, f in futs if f.done()]
            if any(getattr(f, "_mxtpu_version", None) == version
                   for f in done):
                return
            time.sleep(0.005)

    t = threading.Thread(target=pound)
    t.start()
    try:
        served(1)
        v2 = eng.update_params([p.data().asnumpy() * 1.5 for p in
                                _nets()[1].collect_params().values()])
        served(2)
    finally:
        stop.set()
        t.join(timeout=5)
        b.close()
    ref2 = np.asarray(eng.infer(x))
    assert v2 == 2 and eng.recompile_count == 0
    assert not np.allclose(ref1, ref2)
    seen = set()
    for i, f in futs:
        if f.exception(timeout=5) is not None:
            continue   # close() failed the tail of the stream
        seen.add(f._mxtpu_version)
        np.testing.assert_array_equal(
            f.result(), ref1[i] if f._mxtpu_version == 1 else ref2[i])
    assert seen == {1, 2}


def test_engine_stress_threads_and_swaps():
    """Six threads call ``infer`` while another swaps versions in, with a
    1 us switch interval: every call is counted (no lost update under the
    run lock) and every output is its recorded version's, bit for bit."""
    eng = _warm(PORT)
    x = _x(3, 14)
    base = [p.data().asnumpy() for p in _nets()[1].collect_params().values()]
    scales = {1: 1.0, 2: 1.25, 3: 0.75, 4: 1.5}
    refs = {}
    for v, k in scales.items():
        e = _warm(PORT)
        if v > 1:
            e.update_params([a * k for a in base])
        refs[v] = np.asarray(e.infer(x))
    results, errors = [], []
    lock = threading.Lock()

    def caller():
        try:
            for _ in range(25):
                out = eng.infer(x)
                with lock:
                    results.append((eng.last_version_served, out))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller) for _ in range(6)]
        for t in threads:
            t.start()
        for v in (2, 3, 4):
            time.sleep(0.01)
            assert eng.update_params([a * scales[v] for a in base]) == v
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert eng.infer_calls == len(results) == 150
    assert eng.rows_served == 150 * 3 and eng.recompile_count == 0
    for _v, out in results:
        # last_version_served is read after the call returns, so another
        # call may have moved it: the output must be one version's, whole
        assert any(np.array_equal(np.asarray(out), r) for r in refs.values())


@pytest.mark.parametrize("value,env,want", [
    (None, None, "warn"), (None, "error", "error"), ("off", "error", "off"),
    ("loud", None, ValueError)])
def test_resolve_mode_matches_reference(value, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("MXTPU_LINT", raising=False)
    else:
        monkeypatch.setenv("MXTPU_LINT", env)
    for aot in (jaot, taot):
        args = (value, "MXTPU_LINT", "warn", ("off", "warn", "error"), "lint")
        if want is ValueError:
            with pytest.raises(ValueError, match="lint must be one of"):
                aot.resolve_mode(*args)
        else:
            assert aot.resolve_mode(*args) == want
