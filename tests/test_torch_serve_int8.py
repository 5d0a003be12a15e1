"""The port's weight-only int8 serving tier (``ServeEngine(dtype="int8")``)
against the JAX package, on the CPU.

The reference's int8 engine is its ``quantize_int8`` graftpass, which
walks jaxprs with ``jax.core.ClosedJaxpr`` and so cannot run under the
JAX these tests may meet.  The pass is ``dequantize_tensor`` in a
prologue (``analysis/passes.py:784-795``), so the tier is held to what
does run:

- its codes and amax bit-equal to the reference's ``quantize_tensor`` for
  every eligible parameter (floating, ndim >= 2), and every other
  parameter left float;
- its outputs within ``TOL`` of the reference's float
  ``ServeEngine(..., lint="off")`` loaded with ``dequantize_tensor`` of
  those codes, on the MLP and the conv/BN/max-pool net of
  ``tests/test_torch_serve.py`` (its nets, ``TOL`` and helpers), at every
  bucket and chunked;
- the reference's own int8 tolerances against the f32 engine
  (``tests/test_serve.py:218-242``): 2 % of the largest logit with equal
  argmax on the MLP, 5 % on the conv net;
- a swap that requantizes, with no capture (``tests/test_serve_resilience
  .py:567``), held to the reference's float engine after the same swap;
  a poisoned swap rolled back with the codes bitwise unchanged;
  ``shadow_infer`` quantizing its candidate;
- the breaker degrading to the int8 fallback and recovering (``:427``);
- a candidate whose quantization layout drifts refused;
- the slot holding no float copy of an eligible tensor.

Every wait is bounded and every batcher closed in ``finally``.
"""
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import quantization as jq

from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
from incubator_mxnet_tpu_torch.serve import (CircuitBreaker,
                                             ContinuousBatcher, LintError,
                                             ServeEngine, SwapRejected)

from test_torch_serve import _close, _pair, _ref_engine, _sample, _x

#: the reference's int8-vs-f32 tolerances (tests/test_serve.py:226, :242)
INT8_TOL = {"mlp": 0.02, "cnn": 0.05}

_PAIRS = {}


def _nets(kind):
    if kind not in _PAIRS:
        _PAIRS[kind] = _pair(kind)
    return _PAIRS[kind]


def _int8(kind, buckets=(2, 8)):
    eng = ServeEngine(_nets(kind)[1], buckets=buckets, dtype="int8",
                      device="cpu")
    eng.warmup(_sample(kind))
    return eng


def _fp32(kind, buckets=(2, 8)):
    eng = ServeEngine(_nets(kind)[1], buckets=buckets, device="cpu")
    eng.warmup(_sample(kind))
    return eng


def _dequantized(raw):
    """The reference's ``dequantize_tensor(quantize_tensor(w))`` for every
    eligible array, the others as they are."""
    import jax.numpy as jnp

    out = []
    for a in raw:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating) and a.ndim >= 2:
            q, amax = jq.quantize_tensor(jnp.asarray(a))
            a = np.asarray(jq.dequantize_tensor(q, amax))
        out.append(a)
    return out


def _ref_on_codes(kind, raw, buckets=(2, 8)):
    """The reference's float engine serving the dequantized codes of
    ``raw``."""
    ref = _ref_engine(_nets(kind)[0], kind, buckets=buckets)
    ref.update_params(_dequantized(raw))
    return ref


def _raw(eng):
    return [p.data().asnumpy() for p in eng._params]


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_codes_bit_equal_to_reference(kind):
    import jax.numpy as jnp

    eng = _int8(kind)
    raw = _raw(eng)
    assert eng._quantized == [a.ndim >= 2 for a in raw]
    assert any(eng._quantized) and not all(eng._quantized)
    for slot in eng._slots:
        for v, q, a in zip(slot.values, eng._quantized, raw):
            if q:
                jc, ja = jq.quantize_tensor(jnp.asarray(a))
                assert v[0].dtype == torch.int8 and v[1].shape == ()
                np.testing.assert_array_equal(v[0].numpy(), np.asarray(jc))
                assert v[1].numpy().tobytes() == np.asarray(ja).tobytes()
            else:
                assert v.dtype == torch.float32
                np.testing.assert_array_equal(v.numpy(), a)
    quant = [v for v, q in zip(eng._p_vals, eng._quantized) if q]
    assert quant and all(v[0].dtype == torch.int8 for v in quant)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_int8_engine_matches_reference_on_codes(kind):
    eng = _int8(kind)
    ref = _ref_on_codes(kind, _raw(eng))
    for n, seed in ((1, 1), (2, 2), (5, 3), (8, 4), (11, 5)):
        x = _x(n, kind, seed)
        _close(eng.infer(x).numpy(), np.asarray(ref.infer(x)))
    for attr in ("infer_calls", "rows_served", "padded_rows",
                 "recompile_count"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    # the reference engine was swapped to the codes once
    assert eng.last_version_served + 1 == ref.last_version_served == 2
    assert eng.param_signature == [(n, s, np.dtype(d)) for n, s, d in
                                   ref.param_signature]


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_int8_tier_against_fp32_reference_tolerance(kind):
    x = _x(6, kind, 4)
    fp32 = _fp32(kind, buckets=(8,)).infer(x).numpy()
    got = _int8(kind, buckets=(8,)).infer(x).numpy()
    np.testing.assert_allclose(got, fp32,
                               atol=INT8_TOL[kind] * np.abs(fp32).max())
    if kind == "mlp":
        assert np.argmax(got, 1).tolist() == np.argmax(fp32, 1).tolist()


def test_swap_requantizes_without_capture():
    e8 = _int8("mlp", buckets=(8,))
    recomp0 = e8.recompile_count
    new = [a * 0.5 for a in _raw(e8)]
    assert e8.update_params(new) == 2
    assert e8.recompile_count == recomp0
    quant = [v for v, q in zip(e8._p_vals, e8._quantized) if q]
    assert quant and all(v[0].dtype == torch.int8 for v in quant)
    x = _x(4, "mlp", 8)
    # the reference's check (tolerance against the f32 engine after the
    # same swap) and the parity check on the swapped codes
    fp = _fp32("mlp", buckets=(8,))
    fp.update_params(new)
    ref = fp.infer(x).numpy()
    got = e8.infer(x).numpy()
    np.testing.assert_allclose(got, ref, atol=0.02 * np.abs(ref).max())
    ref_codes = _ref_on_codes("mlp", new, buckets=(8,))
    _close(got, np.asarray(ref_codes.infer(x)))


def test_poisoned_swap_rolls_back_codes_bitwise():
    e8 = _int8("mlp", buckets=(8,))
    x = _x(3, "mlp", 9)
    before = e8.infer(x).numpy()
    snap = fi._live_param_snapshot(e8)
    # NaN in a float (unquantized) parameter: the canary sees it
    cand = _raw(e8)
    cand[1] = cand[1].copy()
    cand[1][0] = np.nan
    with pytest.raises(SwapRejected, match="non-finite"):
        e8.update_params(cand)
    after = fi._live_param_snapshot(e8)
    assert snap[0] == after[0] == 1
    assert len(snap[1]) == len(after[1]) == len(e8._quantized) + \
        sum(e8._quantized)
    assert all(fi._leaves_equal(a, b) for a, b in zip(snap[1], after[1]))
    np.testing.assert_array_equal(e8.infer(x).numpy(), before)
    assert e8.rollback_count == 1
    # NaN in a quantized weight: the reference's guard zeroes its codes
    # (amax 0), so the canary's output stays finite and the swap commits
    poisoned = fi.nan_params(e8)
    assert np.isnan(poisoned[0]).any() and e8._quantized[0]
    assert e8.update_params(poisoned) == 2
    codes, amax = e8._p_vals[0]
    assert float(amax) == 0.0 and not codes.any()


def test_shadow_infer_quantizes_candidate():
    e8 = _int8("mlp")
    new = [a * 0.75 for a in _raw(e8)]
    x = _x(5, "mlp", 10)
    live = e8.infer(x).numpy()
    shadow = e8.shadow_infer(x, candidate=new).numpy()
    _close(shadow, np.asarray(_ref_on_codes("mlp", new).infer(x)))
    np.testing.assert_array_equal(e8.shadow_infer(x).numpy(), live)
    assert e8.params_version == 1 and e8.infer_calls == 1


def test_breaker_degrades_to_int8_fallback_and_recovers():
    """The reference's ladder: the primary burns, the breaker opens,
    traffic serves from the int8 tier (counted and attributed), and the
    half-open probe brings the primary back."""
    eng = _fp32("mlp", buckets=(4, 8))
    fb = _int8("mlp", buckets=(4, 8))
    brk = CircuitBreaker(failure_threshold=1, recovery_time=0.08)
    b = ContinuousBatcher(eng, max_delay=0.005, breaker=brk, fallback=fb)
    x = _x(4, "mlp", 3)
    ref8 = fb.infer(x).numpy()
    try:
        with fi.engine_failure_burst(4, engine=eng):
            futs = [b.submit(x[i]) for i in range(2)]
            rows = [np.asarray(f.result(timeout=5)) for f in futs]
            for f in futs:
                assert f._mxtpu_tier == "fallback"
            time.sleep(0.1)  # the probe fires into the still-burning burst
        assert b.stats.degraded >= 2
        for i, r in enumerate(rows):
            np.testing.assert_array_equal(r, ref8[i])
        deadline = time.monotonic() + 5.0
        while brk.state != CircuitBreaker.CLOSED and \
                time.monotonic() < deadline:
            time.sleep(0.1)
            b.submit(x[0]).result(timeout=5)
        assert brk.state == CircuitBreaker.CLOSED
    finally:
        b.close()


def test_layout_drift_refused():
    e8 = _int8("mlp")
    good = _raw(e8)
    with pytest.raises(LintError, match="GL011"):
        e8.update_params([good[0].astype(np.float64)] + good[1:])
    # past GL011 the layout check is the reference's belt and braces
    served = list(e8._quantized)
    e8._quantized = [not q for q in served]
    try:
        with pytest.raises(RuntimeError, match="layout drifted"):
            e8.update_params(good)
        with pytest.raises(RuntimeError, match="layout drifted"):
            e8.shadow_infer(_x(2), candidate=good)
    finally:
        e8._quantized = served
    assert e8.params_version == 1 and e8.rollback_count == 0


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_slot_holds_no_float_copy(kind):
    e8 = _int8(kind)
    eligible = {path for slot in e8._slots for path, _p, _d in slot.quant}
    assert len(eligible) == sum(e8._quantized)
    for slot in e8._slots:
        net = slot.net
        tensors = dict(net.named_parameters(remove_duplicate=False))
        tensors.update(net.named_buffers(remove_duplicate=False))
        for path, t in tensors.items():
            if path in eligible:
                assert t.device.type == "meta", path
            else:
                assert t.device.type == "cpu" and t.ndim < 2, path
        for p in net.collect_params().values():
            t = p._tensor
            assert t.device.type == "meta" or t.ndim < 2, p.name
    f32 = _fp32(kind)
    n_q = sum(int(np.prod(s)) for (_n, s, _d), q in
              zip(e8.param_signature, e8._quantized) if q)
    assert f32.resident_bytes - e8.resident_bytes == 3 * n_q - \
        4 * sum(e8._quantized)


def test_int8_refuses_non_float_compute_dtypes():
    with pytest.raises(ValueError, match="float dtype"):
        ServeEngine(_nets("mlp")[1], buckets=(4,), dtype="int32",
                    device="cpu")
