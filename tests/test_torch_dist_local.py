"""The data-parallel layer in one process, without a launcher: what needs
no second rank.

- ``gluon.utils`` (``split_data``, ``split_and_load``,
  ``clip_global_norm``, ``check_sha1``, ``download``) against the JAX
  package's on the same inputs (exact, and 1e-6 relative for the norm);
- ``distributed.resplit_iter_state`` against the reference's on the same
  iterator states, refusals included;
- ``initialize``: world size 1 returns without a group, a rendezvous with
  no coordinator raises ``DistributedInitError`` naming it and the rank;
- the refusals of ``make_mesh``, of the collectives' shape checks and
  ``ppermute``'s permutation check (on a two-rank mesh object), of
  ``zero``, and of a checkpoint of a step whose mesh spans processes
  that one rank cannot commit alone;
  the collectives' one-rank values without a group;
- ghost BN's group picked for the global batch (``batch=``): each half
  of a batch normalizes as the reference's whole-batch call does on its
  rows (1e-5), and a group no half can hold raises;
- a dp mesh of one: the step of ``zero`` 0 and 1 equals the step without
  a mesh bit for bit, and stamps its topology;
- the dist store types without a launcher environment warn and run
  single-worker (``dist_async`` too at one worker), a Trainer over one
  pushes nothing; ``horovod`` and ``tpu`` are local stores, as in the
  reference.
"""
import hashlib
import json
import socket

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import utils as jutils
from incubator_mxnet_tpu.parallel import distributed as jdist

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, gluon
from incubator_mxnet_tpu_torch.gluon import utils as tutils
from incubator_mxnet_tpu_torch.parallel import collectives as coll
from incubator_mxnet_tpu_torch.parallel import distributed as tdist
from incubator_mxnet_tpu_torch.parallel import make_mesh, make_train_step
from incubator_mxnet_tpu_torch.parallel.mesh import Mesh, spans_processes

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _no_launcher(monkeypatch):
    for k in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "DMLC_PS_ROOT_URI",
              "DMLC_PS_ROOT_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not tdist.is_initialized()


# -- gluon.utils -------------------------------------------------------------

def test_split_data_and_load_match_reference():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    for num, even in ((2, True), (3, False), (5, True)):
        got = tutils.split_data(tmx.nd.array(x, ctx=CPU), num,
                                even_split=even)
        want = jutils.split_data(jmx.nd.array(x), num, even_split=even)
        assert [g.asnumpy().tolist() for g in got] == \
            [w.asnumpy().tolist() for w in want]
    got = tutils.split_data(tmx.nd.array(x.T.copy(), ctx=CPU), 2,
                            batch_axis=1)
    want = jutils.split_data(jmx.nd.array(x.T.copy()), 2, batch_axis=1)
    assert [g.asnumpy().tolist() for g in got] == \
        [w.asnumpy().tolist() for w in want]
    for mod, arr in ((tutils, tmx.nd.array(x, ctx=CPU)),
                     (jutils, jmx.nd.array(x))):
        with pytest.raises(ValueError, match="evenly split"):
            mod.split_data(arr, 3)
    loaded = tutils.split_and_load(x, [CPU, CPU])
    assert [a.asnumpy().tolist() for a in loaded] == \
        [x[:5].tolist(), x[5:].tolist()]
    assert all(a._data.device == CPU for a in loaded)
    one = tutils.split_and_load(tmx.nd.array(x, ctx=CPU), [CPU])
    assert len(one) == 1 and one[0].shape == (10, 3)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_global_norm_matches_reference(max_norm):
    rng = np.random.RandomState(3)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((4, 3), (7,), (2, 2, 2))]
    t = [tmx.nd.array(a, ctx=CPU) for a in arrays]
    j = [jmx.nd.array(a) for a in arrays]
    tn = tutils.clip_global_norm(t, max_norm)
    jn = jutils.clip_global_norm(j, max_norm)
    assert isinstance(tn, float)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)


def test_check_sha1_and_download(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert tutils.check_sha1(str(path), digest)
    assert not tutils.check_sha1(str(path), "0" * 40)
    assert jutils.check_sha1(str(path), digest)
    with pytest.raises(RuntimeError, match="network"):
        tutils.download("http://example.invalid/x")


# -- resplit_iter_state ------------------------------------------------------

def _part(r, n, cursor=3):
    return {"epoch": 1, "cursor": cursor, "rng": [1, 2, 3],
            "inner": {"part_index": r, "num_parts": n, "order": [4, 5]},
            "part_index": r, "num_parts": n}


@pytest.mark.parametrize("parts,index,num", [
    ({0: _part(0, 2), 1: _part(1, 2)}, 1, 2),
    ({"0": _part(0, 2), "1": _part(1, 2)}, 0, 3),
    ({0: _part(0, 3), 1: _part(1, 3), 2: _part(2, 3)}, 0, 1),
])
def test_resplit_matches_reference(parts, index, num):
    assert tdist.resplit_iter_state(parts, index, num) == \
        jdist.resplit_iter_state(parts, index, num)


@pytest.mark.parametrize("parts,index,num,match", [
    ({0: _part(0, 2), 1: _part(1, 2, cursor=4)}, 0, 3, "diverged"),
    ({0: _part(0, 2), 2: _part(2, 2)}, 0, 2, "contiguous"),
    ({0: _part(0, 1)}, 1, 1, "outside"),
    ({}, 0, 1, "no saved"),
])
def test_resplit_refusals_match_reference(parts, index, num, match):
    for mod in (tdist, jdist):
        with pytest.raises(ValueError, match=match):
            mod.resplit_iter_state(parts, index, num)


# -- initialize ---------------------------------------------------------------

def test_initialize_world_one_does_not_latch():
    assert tdist.initialize() == 1
    assert tdist.initialize(num_processes=1) == 1
    assert not tdist.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.backend() is None
    tdist.barrier("alone")
    assert tdist.collectives_supported()


def test_rendezvous_failure_names_coordinator_and_rank():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    where = "127.0.0.1:%d" % port
    with pytest.raises(tdist.DistributedInitError,
                       match=r"process 1/2 .*%s" % where):
        tdist.initialize(coordinator=where, num_processes=2, process_id=1,
                         timeout=1, device="cpu")
    assert not tdist.is_initialized()


def test_backend_rule():
    assert tdist._choose_backend(2, "cpu") == "gloo"
    assert tdist._choose_backend(1, "cpu") == "gloo"
    expect = "nccl" if torch.cuda.is_available() else "gloo"
    assert tdist._choose_backend(1, None) == expect


# -- mesh and collectives -----------------------------------------------------

def test_make_mesh_refusals():
    for axes in ({"tp": 1}, {"dp": 1, "pp": 1}, {"sp": 1}, {"ep": 1}):
        with pytest.raises(NotImplementedError, match="A8 items c and d"):
            make_mesh(axes, devices=[CPU])
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh({"dp": 2}, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="needs 1 devices, have 2"):
        make_mesh({"dp": 1}, devices=[CPU, CPU])
    mesh = make_mesh({"dp": -1}, devices=[CPU])
    assert mesh.shape == {"dp": 1} and mesh.group("dp") is None
    assert not spans_processes(mesh) and mesh.local_device == CPU
    with pytest.raises(ValueError, match="not 'tp'"):
        mesh.group("tp")


def _two_ranks():
    """A two-rank mesh object without a group: the checks run, no call."""
    return Mesh(("dp",), [2], [CPU, CPU], [None])


def test_collective_shape_checks():
    mesh = _two_ranks()
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="concat 2 is out of range"):
        coll.allgather(x, "dp", mesh, axis=2)
    with pytest.raises(ValueError, match="does not divide by the axis"):
        coll.reduce_scatter(x, "dp", mesh, scatter_dimension=0)
    with pytest.raises(ValueError, match="scatter 3 is out of range"):
        coll.reduce_scatter(x, "dp", mesh, scatter_dimension=3)
    with pytest.raises(ValueError, match="not the axis size"):
        coll.reduce_scatter(x, "dp", mesh, scatter_dimension=1, tiled=False)
    with pytest.raises(ValueError, match="split dimension 0 has size 3"):
        coll.alltoall(x, "dp", split_axis=0, concat_axis=1, mesh=mesh)
    with pytest.raises(ValueError, match="does not divide by the axis"):
        coll.reduce_scatter_coalesced([torch.zeros(4), x], "dp", mesh)
    with pytest.raises(ValueError, match="outside the axis"):
        coll.ppermute(x, "dp", [(0, 2)], mesh)
    with pytest.raises(ValueError, match="destination ranks \\[1\\]"):
        coll.ppermute(x, "dp", [(0, 1), (1, 1)], mesh)
    with pytest.raises(ValueError, match="source 2"):
        coll.broadcast_from(x, "dp", src=2, mesh=mesh)
    with pytest.raises(ValueError, match="batch of 3"):
        mesh.local_slice(x)
    assert mesh.local_slice(torch.arange(4.)).tolist() == [0.0, 1.0]


def test_collectives_without_a_group_are_one_rank():
    coll.reset_call_counts()
    x = torch.arange(6.).reshape(2, 3)
    assert torch.equal(coll.allreduce(x), x)
    assert torch.equal(coll.pmean(x), x)
    assert torch.equal(coll.allgather(x, axis=1), x)
    assert torch.equal(coll.allgather(x, axis=1, tiled=False),
                       x.unsqueeze(1))
    assert torch.equal(coll.reduce_scatter(x, scatter_dimension=1), x)
    assert torch.equal(coll.alltoall(x, split_axis=1, concat_axis=0), x)
    assert torch.equal(coll.ppermute(x, perm=[(0, 0)]), x)
    assert torch.equal(coll.ppermute(x, perm=[]), torch.zeros_like(x))
    assert torch.equal(coll.broadcast_from(x), x)
    assert (coll.axis_size(), coll.axis_index()) == (1, 0)
    assert coll.allreduce_coalesced([x, x.int()])[1].dtype == torch.int32
    assert coll.call_counts() == {}


# -- the train step -----------------------------------------------------------

def _mlp():
    tmx.random.seed(0)
    with context.device_scope("cpu"):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(8, in_units=5, activation="relu"),
                gluon.nn.Dense(13, in_units=8))
    net.initialize(init=tmx.init.Xavier())
    return net


def _step(net, **kw):
    return make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           device="cpu", learning_rate=0.1,
                           multi_precision=True, **kw)


def test_zero_refusals():
    with pytest.raises(ValueError, match="zero must be 0"):
        _step(_mlp(), zero=2)
    with pytest.raises(ValueError, match="pass a mesh"):
        _step(_mlp(), zero=1)
    mesh = make_mesh({"dp": 1}, devices=[CPU])
    with pytest.raises(ValueError, match="elementwise update"):
        make_train_step(_mlp(), gluon.loss.SoftmaxCrossEntropyLoss(),
                        optimizer="rmsprop", device="cpu", mesh=mesh, zero=1)
    with pytest.raises(ValueError, match="'data' mesh axis"):
        _step(_mlp(), mesh=mesh, batch_axis="data", zero=1)
    with pytest.raises(ValueError, match="batch axis 'data'"):
        _step(_mlp(), mesh=mesh, batch_axis="data")


def test_ghost_group_is_picked_for_the_global_batch():
    """``ghost_bn_act(..., batch=16)`` on each half of a batch of 16 (a
    cap of 4: the reference's group 4) gives the reference's rows and
    group statistics for that half, as the reference's one call over the
    whole batch does; with no cap the reference's group for 16 is 16,
    which a half of 8 cannot hold."""
    import jax.numpy as jnp
    from incubator_mxnet_tpu.parallel import fused_bn as jfb

    from incubator_mxnet_tpu_torch.parallel import fused_bn as tfb

    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 32, 6, 6)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    beta = (rng.normal(size=32) * 0.2).astype(np.float32)
    want = [np.asarray(a) for a in jfb.ghost_bn_act(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps=1e-5,
        group=4)]
    halves = [torch.from_numpy(x[:8]), torch.from_numpy(x[8:])]
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    for r, xr in enumerate(halves):
        y, m, v = tfb.ghost_bn_act(xr, g, b, eps=1e-5, group=4, batch=16)
        for got, ref, rows in ((y, want[0], 8), (m, want[1], 2),
                               (v, want[2], 2)):
            np.testing.assert_allclose(got.numpy(),
                                       ref[rows * r:rows * (r + 1)],
                                       rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match=r"ghost group 16 .*global batch "
                                         r"16\) .*this rank's batch 8"):
        tfb.ghost_bn_act(halves[0], g, b, eps=1e-5, batch=16)


def test_dp_mesh_of_one_is_the_plain_step():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(6, 5).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 13, 6).astype(np.float32))
    mesh = make_mesh({"dp": 1}, devices=[CPU])
    runs = []
    for kw in ({}, {"mesh": mesh}, {"mesh": mesh, "zero": 1}):
        net = _mlp()
        step = _step(net, **kw)
        losses = [step(x, y).item() for _ in range(3)]
        runs.append((losses, [p.detach().clone() for p in net.parameters()],
                     step._topology()))
    for losses, params, _ in runs[1:]:
        assert losses == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][1]))
    assert runs[0][2]["mesh"] is None
    assert runs[2][2] == {"mesh": {"dp": 1}, "batch_axis": "dp", "zero": 1,
                          "pipeline_stages": None, "processes": 1}


def test_checkpoints_of_a_multi_process_step_refuse(tmp_path):
    """Rank 0 of a two-rank ZeRO-1 step (a mesh object, no peer): its
    ZeRO leaves are its rows of the padded leaves; a one-process manager
    refuses to write them, and a two-process one stages them and times
    out naming rank 1's missing done-marker, committing nothing.  The
    name is the one this test had when multi-process checkpoints were
    refused; of those refusals only the one-process manager's stays."""
    from incubator_mxnet_tpu_torch.parallel import checkpoint as tck

    step = _step(_mlp(), mesh=_two_ranks(), zero=1)
    assert step._topology()["mesh"] == {"dp": 2}
    shards = [leaf for _, leaf in tck._flatten(step._checkpoint_state())
              if isinstance(leaf, tck.Shard)]
    # (momentum, f32 master weight) of each parameter; 13 rows pad to 14
    assert [(s.shape, s.rows, s.ordinal, s.count) for s in shards] == [
        (shape, rows, 0, 2) for shape, rows in (
            ((8, 5), (0, 4)), ((8,), (0, 4)), ((14, 8), (0, 7)),
            ((14,), (0, 7))) for _ in range(2)]
    with pytest.raises(tck.CheckpointError, match="process_count=2"):
        step.save_checkpoint(str(tmp_path / "one"))
    mgr = tck.CheckpointManager(str(tmp_path / "two"), process_index=0,
                                process_count=2, commit_timeout=0.3)
    assert step.attach_checkpoint(mgr) is mgr
    with pytest.raises(tck.CheckpointError, match="done-marker"):
        step.save_checkpoint(mgr)
    assert mgr.steps() == []
    with pytest.raises(tck.CheckpointError, match="no checkpoints"):
        step.restore_checkpoint(mgr)


# -- the stores without a launcher ---------------------------------------------

@pytest.mark.parametrize("name", ["dist", "dist_sync", "dist_sync_device",
                                  "dist_device_sync", "dist_async"])
def test_dist_types_without_launcher_run_single_worker(name):
    with pytest.warns(UserWarning, match="launcher environment"):
        store = tmx.kv.create(name)
    assert isinstance(store, tmx.kv.DistKVStore)
    assert (store.rank, store.num_workers, store.type) == (0, 1, name)
    store.init("w", tmx.nd.full((2, 3), 4.0, ctx=CPU))
    store.push("w", [tmx.nd.ones((2, 3), ctx=CPU),
                     tmx.nd.ones((2, 3), ctx=CPU)])
    out = tmx.nd.zeros((2, 3), ctx=CPU)
    store.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 2.0))
    store.barrier()


def test_trainer_over_a_one_worker_dist_store_pushes_nothing():
    with pytest.warns(UserWarning):
        store = tmx.kv.create("dist_sync")
    net = _mlp()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore=store)
    x = tmx.nd.array(np.ones((2, 5), np.float32), ctx=CPU)
    with tmx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(2)
    assert store._store == {}


@pytest.mark.parametrize("name", ["horovod", "tpu"])
def test_horovod_and_tpu_are_local_stores(name):
    coll.reset_call_counts()
    store = tmx.kv.create(name)
    ref = jmx.kv.create(name)
    assert type(store).__name__ == type(ref).__name__ == "KVStore"
    assert (store.type, store.rank, store.num_workers) == (name, 0, 1)
    store.init(5, tmx.nd.ones((3,), ctx=CPU))
    store.push(5, tmx.nd.full((3,), 2.0, ctx=CPU))
    out = tmx.nd.zeros((3,), ctx=CPU)
    store.pull(5, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((3,), 2.0))
    assert json.dumps(coll.call_counts()) == "{}"
