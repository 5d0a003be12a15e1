"""The port's bounded-staleness parameter service
(``incubator_mxnet_tpu_torch/parallel/param_service.py``), its
compressors (``kvstore/gradient_compression.py``) and the
``make_train_step(sync=...)`` rung against the JAX package's
(``tests/test_param_service.py``), on the CPU.

- The clock and ``SyncPolicy`` fed the same seeded operations equal the
  reference's exactly (pure Python).  The updater and the server given
  the same pushes hold parameters within ``UPDATE_ATOL`` of the
  reference's (f32 optimizer arithmetic, rounded differently), with the
  same versions, clock and push accounting.
- 2-bit, top-k and int8 payloads and residuals over 4 steps of error
  feedback equal the reference's bit for bit.  Random-k draws its
  positions from a ``torch.Generator``, so its indices are its own: the
  kept count and the error-feedback identity (sent + residual = gradient
  + old residual) hold exactly, and with the reference's indices handed
  over the payload values and residuals equal the reference's.
- The async step against the reference's over 3 steps from the same
  weights (top-k compression): losses and parameters within
  ``STEP_ATOL``.  The refused compositions raise the reference's
  messages.  ``slow_link``/``drop_push`` count as the reference's do
  (the same drops from the same seed).  Kill-and-resume of the client
  and of the async step is bit-identical.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.kvstore import gradient_compression as jgc
from incubator_mxnet_tpu.parallel import fault_injection as jfi
from incubator_mxnet_tpu.parallel import make_train_step as jmake
from incubator_mxnet_tpu.parallel import param_service as jps
from incubator_mxnet_tpu.parallel.train_step import \
    FunctionalOptimizer as JOpt

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.kvstore import gradient_compression as tgc
from incubator_mxnet_tpu_torch.parallel import CheckpointManager
from incubator_mxnet_tpu_torch.parallel import fault_injection as tfi
from incubator_mxnet_tpu_torch.parallel import make_train_step as tmake
from incubator_mxnet_tpu_torch.parallel import param_service as tps
from incubator_mxnet_tpu_torch.parallel.train_step import \
    FunctionalOptimizer as TOpt

CPU = torch.device("cpu")
#: the updater's and the server's parameters, port against reference
UPDATE_ATOL = 1e-6
#: the async step's losses and parameters after 3 steps
STEP_ATOL = 1e-5

pytestmark = pytest.mark.filterwarnings("ignore:.*GL0")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# the clock, the updater, the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_clock_parity(seed):
    rng = np.random.RandomState(seed)
    clocks = [jps.StalenessClock(), tps.StalenessClock()]
    for _ in range(80):
        op = rng.randint(4)
        r = int(rng.randint(4))
        at = None if rng.rand() < 0.7 else int(rng.randint(6))
        for c in clocks:
            if op == 0:
                c.register(r, at)
            elif op == 1:
                c.deregister(r)
            else:
                c.advance(r)
        got = [(c.live_ranks(), c.min_step(), [c.staleness(k)
                                               for k in range(4)])
               for c in clocks]
        assert got[0] == got[1]
    sj, st = clocks[0].state_dict(), clocks[1].state_dict()
    assert {k: {r: int(v) for r, v in d.items()} for k, d in sj.items()} \
        == {k: {r: int(v) for r, v in d.items()} for k, d in st.items()}
    back = tps.StalenessClock()
    back.load_state_dict(sj)  # the reference's state loads here
    assert back.live_ranks() == clocks[0].live_ranks()


@pytest.mark.parametrize("opt", [dict(name="sgd", momentum=0.9, wd=1e-4),
                                 dict(name="adam"),
                                 dict(name="sgd", momentum=0.0)])
def test_updater_and_server_parity(opt):
    rng = np.random.RandomState(0)
    w0 = {k: rng.randn(*s).astype(np.float32)
          for k, s in (("0", (8, 4)), ("1", (4,)), ("w", (16,)))}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in w0.items()} for _ in range(5)]
    kw = dict(opt)
    name = kw.pop("name")
    svcs = [jps.ParamService(jps.ServiceUpdater(
                JOpt(name, learning_rate=0.05, **kw)), num_shards=3),
            tps.ParamService(tps.ServiceUpdater(
                TOpt(name, learning_rate=0.05, **kw)), num_shards=3)]
    for svc in svcs:
        svc.register(0)
        for k, v in w0.items():
            svc.init(k, v)
            svc.init(k, v + 1)  # the first value wins
    for g in grads:
        svcs[0].push(0, {k: jnp.asarray(v) for k, v in g.items()})
        svcs[1].push(0, {k: torch.from_numpy(v) for k, v in g.items()})
    pj, pt = svcs[0].pull(0), svcs[1].pull(0)
    assert sorted(pj) == sorted(pt)
    for k in pj:
        np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), rtol=0,
                                   atol=UPDATE_ATOL)
    sj, st = svcs[0].state_dict(), svcs[1].state_dict()
    assert {k: int(v) for k, v in sj["versions"].items()} == \
        {k: int(v) for k, v in st["versions"].items()} == \
        {k: 5 for k in w0}
    assert {k: int(v) for k, v in sj["updater"]["count"].items()} == \
        {k: int(v) for k, v in st["updater"]["count"].items()}
    assert svcs[0].push_nbytes == svcs[1].push_nbytes
    assert svcs[0].shard_push_nbytes == svcs[1].shard_push_nbytes
    assert svcs[1].clock.step(0) == 5
    with pytest.raises(KeyError):
        svcs[1].push(0, {"nope": torch.ones(1)})


def test_server_copies_and_state_roundtrip():
    svc = tps.ParamService(tps.ServiceUpdater(
        TOpt("sgd", learning_rate=0.1, momentum=0.0)), staleness_bound=3)
    svc.register(0)
    buf = torch.ones(3)
    svc.init("w", buf)
    assert svc.pull(0)["w"] is not buf
    buf += 1
    assert torch.equal(svc.pull(0)["w"], torch.ones(3))
    svc.sync_params({"w": buf})
    assert svc.pull(0)["w"] is not buf
    with pytest.raises(KeyError):
        svc.sync_params({"other": buf})
    svc.push(0, {"w": torch.full((3,), 2.0)})
    state = svc.state_dict()
    svc2 = tps.ParamService(tps.ServiceUpdater(
        TOpt("sgd", learning_rate=0.1, momentum=0.0)), staleness_bound=3)
    svc2.load_state_dict(state)
    svc2.register(0, at_step=int(state["clock"]["count"]["0"]))
    assert svc2.clock.step(0) == 1
    g = torch.full((3,), 0.5)
    svc.push(0, {"w": g})
    svc2.push(0, {"w": g})
    assert torch.equal(svc.pull(0)["w"], svc2.pull(0)["w"])


def test_pull_blocks_at_bound_times_out_and_deregister_unblocks():
    svc = tps.ParamService(staleness_bound=2)
    svc.register(0)
    svc.register(1)
    svc.init("w", torch.zeros(2))
    for _ in range(3):
        svc.push(0, {"w": torch.ones(2)})
    t0 = time.monotonic()
    with pytest.raises(tps.StalenessTimeout):
        svc.pull(0, timeout=0.2)
    assert time.monotonic() - t0 >= 0.15 and svc.pulls_blocked == 1
    svc.push(1, {"w": torch.ones(2)})
    assert set(svc.pull(0, timeout=5.0)) == {"w"}
    assert svc.max_observed_staleness <= svc.staleness_bound
    bsp = tps.ParamService(staleness_bound=0)
    bsp.register(0)
    bsp.register(1)
    bsp.init("w", torch.zeros(2))
    bsp.push(0, {"w": torch.ones(2)})
    got = {}
    t = threading.Thread(target=lambda: got.update(
        out=bsp.pull(0, timeout=30.0)))
    t.start()
    time.sleep(0.1)
    assert t.is_alive()
    bsp.deregister(1)
    t.join(timeout=10.0)
    assert not t.is_alive() and "out" in got
    with pytest.raises(ValueError):
        tps.ParamService(staleness_bound=-1)


def test_straggler_fast_rank_within_bound():
    """Two threaded ranks on one service, rank 1's link slowed: a bound
    as wide as the run never blocks the fast rank; BSP (bound 0) must;
    no pull ever sees staleness past the bound."""
    def run(bound):
        svc = tps.ParamService(tps.ServiceUpdater(
            TOpt("sgd", learning_rate=0.05, momentum=0.0)),
            staleness_bound=bound)
        cls = [tps.ServiceClient(svc, rank=r) for r in (0, 1)]
        for c in cls:
            c.init_params({"w": torch.zeros(8)})

        def body(rank):
            for i in range(12):
                w = cls[rank].pull_params(timeout=60.0)["w"]
                if rank == 1 and i < 4:
                    time.sleep(0.05)
                cls[rank].push_step({"w": w - 1.0})

        ts = [threading.Thread(target=body, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in ts)
        return svc

    wide = run(12)
    assert wide.pulls_blocked == 0 and wide.max_observed_staleness <= 12
    bsp = run(0)
    assert bsp.pulls_blocked > 0 and bsp.max_observed_staleness == 0


# ---------------------------------------------------------------------------
# the compressors
# ---------------------------------------------------------------------------

def _grads(n=4, size=40, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(size).astype(np.float32) for _ in range(n)]


def _payload_np(p):
    if isinstance(p, dict):
        return {k: (_np(v) if k in ("idx", "val", "q", "amax") else v)
                for k, v in p.items()}
    return _np(p)


@pytest.mark.parametrize("spec", ["2bit", {"kind": "topk", "ratio": 0.25},
                                  "int8"])
def test_compressor_payloads_match_reference(spec):
    j, t = jgc.make_compressor(spec), tgc.make_compressor(spec)
    for g in _grads():
        pj = _payload_np(j.compress("w", jnp.asarray(g)))
        pt = _payload_np(t.compress("w", torch.from_numpy(g)))
        if isinstance(pj, dict):
            assert pj["kind"] == pt["kind"] and pj["dtype"] == pt["dtype"]
            assert tuple(pj["shape"]) == tuple(pt["shape"])
            for k in ("idx", "val", "q", "amax"):
                if k in pj:
                    assert pj[k].dtype == pt[k].dtype, k
                    assert pj[k].tobytes() == pt[k].tobytes(), k
        else:
            assert pj.tobytes() == pt.tobytes()
        dj = _np(jgc.decompress_payload(j.compress("v", jnp.asarray(g))))
        dt = _np(tgc.decompress_payload(t.compress("v",
                                                   torch.from_numpy(g))))
        assert dj.tobytes() == dt.tobytes()
        sj, st = j.state_dict(), t.state_dict()
        rj, rt = sj.get("residual", sj), st.get("residual", st)
        assert sorted(rj) == sorted(rt)
        for k in rj:
            assert _np(rj[k]).tobytes() == _np(rt[k]).tobytes()
    assert t.payload_nbytes((40,), np.float32) == \
        j.payload_nbytes((40,), np.float32)


def test_randomk_count_identity_and_reference_indices(monkeypatch):
    t = tgc.RandomKCompressor(ratio=0.25, seed=1)
    j = jgc.RandomKCompressor(ratio=0.25, seed=1)
    res = torch.zeros(40)
    for g in _grads():
        gt = torch.from_numpy(g)
        p = t.compress("w", gt)
        assert p["idx"].dtype == torch.int32 and p["idx"].numel() == 10
        assert len(set(p["idx"].tolist())) == 10
        sent = tgc.decompress_payload(p)
        new_res = t.state_dict()["residual"]["w"]
        # what was sent plus what was banked is the gradient plus the
        # residual carried in, exactly (each element is in one or other)
        assert torch.equal(sent + new_res, gt + res)
        assert torch.equal(sent[p["idx"].long()], (gt + res)[p["idx"].long()])
        res = new_res
    assert int(t.state_dict()["step_of"]["w"]) == 4
    # the reference's positions handed over: the same payload
    real = tgc.RandomKCompressor._indices

    def ref_indices(self, key, g_flat, k):
        pj = j.compress(key, jnp.asarray(ref_indices.g))
        ref_indices.pj = pj
        return torch.from_numpy(np.array(pj["idx"]))

    t2 = tgc.RandomKCompressor(ratio=0.25, seed=1)
    monkeypatch.setattr(tgc.RandomKCompressor, "_indices", ref_indices)
    for g in _grads(seed=9):
        ref_indices.g = g
        pt = t2.compress("w", torch.from_numpy(g))
        pj = ref_indices.pj
        assert _np(pt["idx"]).tobytes() == np.asarray(pj["idx"]).tobytes()
        assert _np(pt["val"]).tobytes() == np.asarray(pj["val"]).tobytes()
        assert _np(t2.state_dict()["residual"]["w"]).tobytes() == \
            np.asarray(j.state_dict()["residual"]["w"]).tobytes()
    monkeypatch.setattr(tgc.RandomKCompressor, "_indices", real)


@pytest.mark.parametrize("spec", ["topk", "randomk", "int8", "2bit"])
def test_compressor_state_roundtrip_bit_identical(spec):
    grads = _grads(size=32)
    a = tgc.make_compressor(spec)
    for g in grads[:2]:
        a.compress("w", torch.from_numpy(g))
    b = tgc.make_compressor(spec)
    b.load_state_dict(a.state_dict())
    da = tgc.decompress_payload(a.compress("w", torch.from_numpy(grads[2])))
    db = tgc.decompress_payload(b.compress("w", torch.from_numpy(grads[2])))
    assert torch.equal(da, db)


def test_make_compressor_specs_and_error_feedback():
    assert tgc.make_compressor(None) is None
    c = tgc.make_compressor("topk")
    assert isinstance(c, tgc.TopKCompressor)
    assert tgc.make_compressor(c) is c
    d = tgc.make_compressor({"kind": "randomk", "ratio": 0.25})
    assert isinstance(d, tgc.RandomKCompressor) and d.ratio == 0.25
    with pytest.raises(ValueError):
        tgc.make_compressor("middle-out")
    with pytest.raises(ValueError):
        tgc.TopKCompressor(ratio=0.0)
    c = tgc.TopKCompressor(ratio=0.25)
    g = torch.tensor([4.0, 1.0, 2.0, 3.0])
    sent = tgc.decompress_payload(c.compress("w", g))
    assert torch.equal(sent + c.state_dict()["residual"]["w"], g)
    q, amax = tgc.symmetric_quantize(torch.zeros(4))
    assert float(amax) == 0.0 and not q.any()


# ---------------------------------------------------------------------------
# the client, the transport's fault injectors
# ---------------------------------------------------------------------------

def test_client_compressed_push_volume_and_kill_resume():
    svc = tps.ParamService()
    cl = tps.ServiceClient(svc, rank=0, compressor=tgc.Int8Compressor())
    cl.init_params({"w": torch.zeros(256)})
    rng = np.random.RandomState(0)
    for _ in range(3):
        cl.push_step({"w": torch.from_numpy(
            rng.randn(256).astype(np.float32))})
    assert svc.push_dense_nbytes == 3 * 256 * 4
    assert svc.push_nbytes / svc.push_dense_nbytes < 0.5
    grads = [torch.from_numpy(g) for g in _grads(n=10, size=64, seed=7)]

    def fresh():
        s = tps.ParamService(tps.ServiceUpdater(
            TOpt("sgd", learning_rate=0.2, momentum=0.0)))
        c = tps.ServiceClient(s, rank=0, owns_service=True,
                              compressor=tgc.RandomKCompressor(ratio=0.5))
        c.init_params({"w": torch.zeros(64)})
        return s, c

    s1, c1 = fresh()
    for g in grads[:6]:
        c1.push_step({"w": g})
    snap = c1.state_dict()
    s2, c2 = fresh()
    c2.load_state_dict(snap)
    assert s2.clock.step(0) == int(snap["rank_step"]) == 6
    for g in grads[6:]:
        c1.push_step({"w": g})
        c2.push_step({"w": g})
    assert torch.equal(c1.pull_params()["w"], c2.pull_params()["w"])


def test_slow_link_and_drop_push_count_as_reference():
    outs = []
    for ps, fi in ((jps, jfi), (tps, tfi)):
        svc = ps.ParamService()
        svc.register(0)
        svc.register(1)
        svc.init("w", np.full((2,), 5.0, np.float32))
        svc.push(1, {"w": np.ones((2,), np.float32)})  # warm the update
        with fi.slow_link(1, 0.05) as slow:
            t0 = time.monotonic()
            svc.push(0, {"w": np.ones((2,), np.float32)})
            fast = time.monotonic() - t0
            t0 = time.monotonic()
            svc.push(1, {"w": np.ones((2,), np.float32)})
            svc.pull(1)
            slowed = time.monotonic() - t0
        assert slowed >= 0.1 > fast
        with fi.drop_push(0.5, seed=4) as drop:
            for _ in range(20):
                svc.push(0, {"w": np.ones((2,), np.float32)})
        svc.deregister(1)  # rank 1 stopped pushing: it holds no bound
        outs.append((slow.pushes, slow.pulls, slow.delayed, drop.seen,
                     drop.dropped, svc.clock.step(0),
                     _np(svc.pull(0, timeout=10.0)["w"]).tolist()))
        with pytest.raises(ValueError):
            fi.drop_push(1.5).__enter__()
    assert outs[0] == outs[1]
    assert 0 < outs[1][4] < 20 and outs[1][5] == 21


def test_drop_push_error_feedback_recarries():
    svc = tps.ParamService(tps.ServiceUpdater(
        TOpt("sgd", learning_rate=0.2, momentum=0.0)))
    cl = tps.ServiceClient(svc, rank=0, compressor=tgc.TopKCompressor(0.5))
    target = torch.linspace(-1, 1, 16)
    cl.init_params({"w": torch.zeros(16)})
    with tfi.drop_push(0.5, seed=1) as stats:
        for _ in range(60):
            w = cl.pull_params()["w"]
            cl.push_step({"w": w - target})
    assert 0 < stats.dropped < stats.seen
    assert float((cl.pull_params()["w"] - target).abs().max()) < 0.2


# ---------------------------------------------------------------------------
# SyncPolicy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "allreduce", "async"])
def test_sync_policy_sequences_match(mode):
    rng = np.random.RandomState(2)
    pj = jps.SyncPolicy(mode=mode, degrade_after=2, recover_after=3)
    pt = tps.SyncPolicy(mode=mode, degrade_after=2, recover_after=3)
    for _ in range(100):
        frame = [1] if rng.rand() < 0.5 else []
        assert pj.observe(frame) == pt.observe(frame)
    assert pj.transitions == pt.transitions
    if mode == "auto":
        assert len(pt.transitions) > 2
    else:
        assert pt.transitions == []
    for kw in (dict(mode="bsp"), dict(degrade_after=0)):
        with pytest.raises(ValueError):
            tps.SyncPolicy(**kw)


# ---------------------------------------------------------------------------
# the async rung of the train step
# ---------------------------------------------------------------------------

def _jax_net(seed=11):
    jmx.random.seed(seed)
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(4))
    net.initialize(init=jmx.init.Xavier())
    net(jnd.ones((2, 8)))
    return net


def _port_net(weights=None, seed=11):
    tmx.random.seed(seed)
    with context.device_scope(CPU):
        net = tgluon.nn.HybridSequential()
        net.add(tgluon.nn.Dense(16, in_units=8, activation="relu"),
                tgluon.nn.Dense(4, in_units=16))
    net.initialize(init=tmx.init.Xavier())
    if weights is not None:
        convert.params_from_jax(net, weights)
    return net


def _batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 8).astype(np.float32),
            (np.arange(n) % 4).astype(np.float32))


def _tstep(net, **kw):
    kw = dict(dict(optimizer="sgd", learning_rate=0.1), **kw)
    return tmake(net, tgluon.loss.SoftmaxCrossEntropyLoss(), device=CPU,
                 **kw)


def test_async_step_matches_reference():
    x, y = _batch()
    jnet = _jax_net()
    weights = [p.data().asnumpy() for p in jnet.collect_params().values()]
    kw = dict(optimizer="sgd", learning_rate=0.1, sync="async",
              staleness_bound=2, compression={"kind": "topk", "ratio": 0.25})
    js = jmake(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), lint="off", **kw)
    ts = _tstep(_port_net(weights), **kw)
    jl = [float(js(jnd.array(x), jnd.array(y)).asscalar()) for _ in range(3)]
    tl = [float(ts(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=STEP_ATOL)
    for p, q in zip(ts._gp, js._gp):
        np.testing.assert_allclose(_np(p), np.asarray(q._data._data),
                                   rtol=0, atol=STEP_ATOL)
    assert ts.sync_mode == "async" and ts.step_count == 3
    svc, jsvc = ts._svc_client.service, js._svc_client.service
    assert svc.push_nbytes == jsvc.push_nbytes < svc.push_dense_nbytes
    assert svc.clock.step(0) == jsvc.clock.step(0) == 3


def test_async_step_trains_and_matches_allreduce_arithmetic():
    x, y = (torch.from_numpy(v) for v in _batch())
    step = _tstep(_port_net(), sync="async", staleness_bound=2,
                  compression={"kind": "topk", "ratio": 0.25})
    losses = [float(step(x, y)) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.7
    # with no compression the service's update is the collective rung's
    # arithmetic: the same parameters bit for bit
    kw = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
              multi_precision=True)
    a = _tstep(_port_net(), **kw)
    b = _tstep(_port_net(), sync="async", staleness_bound=0, **kw)
    for _ in range(3):
        assert torch.equal(a(x, y), b(x, y))
    for p, q in zip(a._gp, b._gp):
        assert torch.equal(p, q)


def test_async_refusals_match_reference():
    import jax

    from incubator_mxnet_tpu.parallel import make_mesh as jmesh
    from incubator_mxnet_tpu_torch.parallel import make_mesh as tmesh

    jnet, tnet = _jax_net(), _port_net()
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    cases = [(dict(sync="async"),
              dict(mesh=jmesh({"dp": 1}, devices=jax.devices()[:1])),
              dict(mesh=tmesh({"dp": 1}, devices=[CPU]))),
             (dict(sync="bsp"), {}, {}),
             (dict(staleness_bound=3), {}, {}),
             (dict(sync="async", staleness_bound=-1), {}, {}),
             (dict(sync="async", loss_scale=128.0), {}, {}),
             (dict(sync="auto", pipeline_stages=2), {}, {})]
    for common, jextra, textra in cases:
        with pytest.raises(ValueError) as je:
            jmake(jnet, jloss, lint="off", **common, **jextra)
        with pytest.raises(ValueError) as te:
            tmake(tnet, tloss, device=CPU, **common, **textra)
        assert str(te.value) == str(je.value), common
    step = _tstep(tnet)
    with pytest.raises(ValueError, match="sync='allreduce'"):
        step.attach_param_service()
    with pytest.raises(ValueError, match="no async rung"):
        step.set_sync_mode("async")


def test_auto_ladder_degrades_and_recovers():
    x, y = (torch.from_numpy(v) for v in _batch())
    step = _tstep(_port_net(), learning_rate=0.3, sync="auto",
                  staleness_bound=4)
    step.sync_policy.recover_after = 3
    losses = [float(step(x, y)) for _ in range(7)]
    assert step.sync_mode == "allreduce"
    assert step.observe_stragglers([1]) == "allreduce"
    assert step.observe_stragglers([1]) == "async"
    losses += [float(step(x, y)) for _ in range(7)]
    for _ in range(3):
        mode = step.observe_stragglers([])
    assert mode == "allreduce" == step.sync_mode
    losses += [float(step(x, y)) for _ in range(7)]
    assert [m for _, m in step.sync_policy.transitions] == \
        ["async", "allreduce"]
    assert losses[-1] < losses[0] * 0.7


def test_async_kill_and_resume_bit_identical(tmp_path):
    x, y = (torch.from_numpy(v) for v in _batch())

    def build(name):
        step = _tstep(_port_net(), sync="async", staleness_bound=2,
                      compression={"kind": "randomk", "ratio": 0.5})
        step.attach_checkpoint(CheckpointManager(str(tmp_path / name)),
                               every=3)
        return step

    ref = build("ref")
    ref_losses = [float(ref(x, y)) for _ in range(10)]
    a = build("killed")
    for _ in range(6):
        a(x, y)
    b = build("killed")
    b.restore_checkpoint(CheckpointManager(str(tmp_path / "killed")))
    assert b.step_count == 6
    assert b._svc_client.service.clock.step(0) == 6
    assert b._svc_client.compressor._step_of["0"] == 6
    tail = [float(b(x, y)) for _ in range(4)]
    assert tail == ref_losses[6:]
