"""The port's multi-process checkpoint commit (``parallel/checkpoint.py``)
against the JAX package's, with in-process managers given
``process_index``/``process_count``, as the reference's own tests drive
one rank of the protocol at a time (``commit_timeout=0``: stage only).

Each case of the reference's ``tests/test_elastic.py`` runs on both
packages with the same outcome: a stale attempt's marker is never
merged; a stage with only some markers is never visible, and the
committed directory (manifest, payloads and markers) is the same bytes
from either package; process 0 times out on a lost peer naming the
done-marker, the torn stage stays invisible, and a re-save of a
committed step does not satisfy a peer's wait; a straggler
(``fault_injection.straggler_process``) is absorbed; sweep and retire
spare a peer's fresh files.  ``watch()`` returns only committed steps.

Mixed writers: the port's manager as one process and the JAX package's
as the other commit one checkpoint, in both orders; both packages
restore it bit for bit, and the markers carry the same JSON keys.
:class:`Shard` leaves: each rank writes its rows as a file; the JAX
package assembles the whole leaf, the port reads back any split of the
rows (padded to another width too) from the files that hold them only,
and a one-process manager refuses to write a part of a sharded leaf.
"""
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.parallel import checkpoint as jck
from incubator_mxnet_tpu.parallel import fault_injection as jfi

from incubator_mxnet_tpu_torch.parallel import checkpoint as tck
from incubator_mxnet_tpu_torch.parallel import fault_injection as tfi

# the JAX manager warns (its GL009 lint) that a temporary directory may
# be process-local; every process here is this one
pytestmark = pytest.mark.filterwarnings("ignore:.*GL009")

PKGS = {"jax": (jck, jfi), "port": (tck, tfi)}


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(6, 4).astype(np.float32), np.int32(seed)


def _tree(pkg, seed):
    w, n = _arrays(seed)
    if pkg == "jax":
        return {"w": jnp.asarray(w), "n": jnp.int32(n)}
    return {"w": torch.from_numpy(w), "n": torch.tensor(n)}


def _np(leaf):
    return leaf.numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_stale_attempt_marker_rejected(tmp_path, monkeypatch, pkg):
    ck, _ = PKGS[pkg]
    d = str(tmp_path / "shared")
    state = _tree(pkg, 3)
    monkeypatch.setenv("MXNET_RESTART_COUNT", "0")
    ck.CheckpointManager(d, process_index=1, process_count=2,
                         commit_timeout=0).save(4, state)
    monkeypatch.setenv("MXNET_RESTART_COUNT", "1")  # relaunched
    m0 = ck.CheckpointManager(d, process_index=0, process_count=2,
                              commit_timeout=0.4)
    with pytest.raises(ck.CheckpointError, match="done-marker"):
        m0.save(4, state)  # attempt 1's rank 1 never arrives
    assert m0.steps() == []
    ck.CheckpointManager(d, process_index=1, process_count=2,
                         commit_timeout=0).save(4, state)
    m0b = ck.CheckpointManager(d, process_index=0, process_count=2,
                               commit_timeout=5)
    m0b.save(4, state)
    assert m0b.steps() == [4]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_commit_is_all_or_nothing(tmp_path, pkg):
    ck, _ = PKGS[pkg]
    d = str(tmp_path / "shared")
    state = _tree(pkg, 1)
    m1 = ck.CheckpointManager(d, process_index=1, process_count=2,
                              commit_timeout=0)
    m0 = ck.CheckpointManager(d, process_index=0, process_count=2,
                              commit_timeout=5)
    m1.save(3, state, meta={"data_iter": {"iter": "X", "consumed": 3}})
    assert m1.steps() == []  # staged and marked, nothing committed
    assert any(n.startswith(".tmp-step-") for n in os.listdir(d))
    m0.save(3, state, meta={"data_iter": {"iter": "X", "consumed": 3}})
    assert m0.steps() == [3]
    with open(os.path.join(d, "step-00000003", "manifest.json")) as f:
        manifest = json.load(f)
    parts = manifest["meta"]["data_iter_parts"]
    assert set(parts) == {"0", "1"}
    assert all(p["consumed"] == 3 for p in parts.values())
    s, got = ck.CheckpointManager(d, process_count=1).restore(_tree(pkg, 9))
    assert s == 3
    np.testing.assert_array_equal(_np(got["w"]), _arrays(1)[0])


def test_committed_files_equal_across_packages(tmp_path, monkeypatch):
    """The same two-process save gives the same bytes from either
    package: manifest, payloads and both markers."""
    monkeypatch.setenv("MXNET_RESTART_COUNT", "2")
    out = {}
    for pkg, (ck, _) in sorted(PKGS.items()):
        d = str(tmp_path / pkg)
        for rank, timeout in ((1, 0), (0, 5)):
            ck.CheckpointManager(d, process_index=rank, process_count=2,
                                 commit_timeout=timeout).save(
                7, _tree(pkg, 5), meta={"data_iter": {"rank": rank}})
        out[pkg] = _files(os.path.join(d, "step-00000007"))
    assert sorted(out["port"]) == ["arr_00000.bin", "arr_00001.bin",
                                   "done-p00000.json", "done-p00001.json",
                                   "manifest.json"]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_commit_times_out_on_lost_peer(tmp_path, pkg):
    ck, _ = PKGS[pkg]
    d = str(tmp_path / "shared")
    state = _tree(pkg, 1)
    ck.CheckpointManager(d, process_index=1, process_count=2,
                         commit_timeout=0).save(1, state)
    m0 = ck.CheckpointManager(d, process_index=0, process_count=2,
                              commit_timeout=5)
    m0.save(1, state)
    assert m0.steps() == [1]
    m0fast = ck.CheckpointManager(d, process_index=0, process_count=2,
                                  commit_timeout=0.4)
    with pytest.raises(ck.CheckpointError, match="done-marker") as ei:
        m0fast.save(2, state)
    assert "process(es) [1]" in str(ei.value)
    assert m0fast.steps() == [1]  # the torn stage is never listed
    assert any(n.startswith(".tmp-step-00000002") for n in os.listdir(d))
    s, _ = ck.CheckpointManager(d, process_count=1).restore(state)
    assert s == 1
    # a re-save of a committed step: the old commit does not satisfy
    # rank 1's wait for this one
    m1b = ck.CheckpointManager(d, process_index=1, process_count=2,
                               commit_timeout=0.4)
    with pytest.raises(ck.CheckpointError, match="commit"):
        m1b.save(1, state)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_commit_absorbs_straggler(tmp_path, pkg):
    ck, fi = PKGS[pkg]
    d = str(tmp_path / "shared")
    state = _tree(pkg, 2)
    m0 = ck.CheckpointManager(d, process_index=0, process_count=2,
                              commit_timeout=20)
    m1 = ck.CheckpointManager(d, process_index=1, process_count=2,
                              commit_timeout=0)
    errs = []

    def coordinator():
        try:
            m0.save(7, state)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=coordinator)
    t.start()
    time.sleep(0.3)  # rank 1 arrives well after rank 0 staged
    with fi.straggler_process(0.2) as stats:
        m1.save(7, state)
    t.join(timeout=30)
    assert not t.is_alive() and not errs, errs
    assert stats.delayed == 1
    assert m0.steps() == [7]


def test_peer_touches_no_stage_after_its_marker(tmp_path, monkeypatch):
    """The interleaving that raced (ROADMAP Queue C): process 1's marker
    lands, and process 0 commits (renames the stage) before process 1
    does anything more.  Process 1 finishes its save, both see the
    committed step, and the committed directory holds both markers."""
    d = str(tmp_path / "shared")
    state = _tree("torch", 2)
    m0 = tck.CheckpointManager(d, process_index=0, process_count=2,
                               commit_timeout=20)
    m1 = tck.CheckpointManager(d, process_index=1, process_count=2,
                               commit_timeout=20)
    final = os.path.join(d, tck._STEP_FMT % 5)
    real = tck._write_bytes
    waited = []

    def marker_then_commit(path, data):
        real(path, data)
        if os.path.basename(path) == tck._DONE_FMT % 1:
            deadline = time.monotonic() + 20
            while not os.path.exists(os.path.join(final, tck._MANIFEST)):
                assert time.monotonic() < deadline, "process 0 never committed"
                time.sleep(0.01)
            waited.append(not os.path.isdir(os.path.dirname(path)))

    monkeypatch.setattr(tck, "_write_bytes", marker_then_commit)
    errs = []

    def coordinator():
        try:
            m0.save(5, state)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=coordinator)
    t.start()
    m1.save(5, state)
    t.join(timeout=30)
    assert not t.is_alive() and not errs, errs
    assert waited == [True]  # the stage was gone when process 1 went on
    assert m0.steps() == m1.steps() == [5]
    assert sorted(n for n in os.listdir(final) if n.startswith("done-")) \
        == [tck._DONE_FMT % 0, tck._DONE_FMT % 1]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_sweep_and_retire_respect_peer_freshness(tmp_path, pkg):
    ck, _ = PKGS[pkg]
    d = str(tmp_path / "shared")
    os.makedirs(d)
    fresh = os.path.join(d, ".tmp-step-00000009")
    os.makedirs(fresh)
    with open(os.path.join(fresh, "arr_00000.bin"), "wb") as f:
        f.write(b"x" * 8)  # a peer's write in flight
    ck.CheckpointManager(d, process_index=0, process_count=2,
                         stale_grace=3600.0)._sweep_stale()
    assert os.path.isdir(fresh)
    ck.CheckpointManager(d, process_index=0, process_count=2,
                         stale_grace=0.0)._sweep_stale()
    assert not os.path.isdir(fresh)
    sp = ck.CheckpointManager(d, keep_last=None, process_count=1)
    for s in (1, 2, 3):
        sp.save(s, _tree(pkg, s))
    mp = ck.CheckpointManager(d, keep_last=1, process_index=0,
                              process_count=2, stale_grace=3600.0)
    mp._retire()
    assert mp.steps() == [1, 2, 3]
    ck.CheckpointManager(d, keep_last=1, process_index=0, process_count=2,
                         stale_grace=0.0)._retire()
    assert mp.steps() == [3]
    for s in (4, 5):
        sp.save(s, _tree(pkg, s))
    ck.CheckpointManager(d, keep_last=1, process_index=1, process_count=2,
                         stale_grace=0.0)._retire()
    assert mp.steps() == [3, 4, 5]  # only process 0 retires


def test_watch_returns_committed_steps_only(tmp_path):
    d = str(tmp_path / "shared")
    m0 = tck.CheckpointManager(d, process_index=0, process_count=2,
                               commit_timeout=10)
    m1 = tck.CheckpointManager(d, process_index=1, process_count=2,
                               commit_timeout=0)
    assert m0.watch(timeout=0.1) is None
    state = _tree("port", 4)
    m1.save(2, state)  # staged only
    os.makedirs(os.path.join(d, "step-00000005"))  # torn: no manifest
    assert m0.watch(timeout=0.2) is None
    t = threading.Thread(target=m0.save, args=(2, state))
    t0 = time.monotonic()
    t.start()
    assert m1.watch(timeout=10) == 2
    t.join()
    assert time.monotonic() - t0 < 10
    assert m1.watch(after=2, timeout=0.1) is None
    assert m1.watch(after=1, timeout=0.1) == 2
    with open(os.path.join(d, "step-00000005", "manifest.json"), "w") as f:
        f.write('{"format_version": 1, "arr')  # torn mid-write
    assert m1.latest_committed() == 2 and m1.latest_step() == 5


@pytest.mark.parametrize("port_rank", [0, 1])
def test_mixed_writers_commit_one_checkpoint(tmp_path, monkeypatch,
                                             port_rank):
    monkeypatch.setenv("MXNET_RESTART_COUNT", "0")
    d = str(tmp_path / "shared")
    meta = {"data_iter": {"iter": "NDArrayIter", "cursor": 16}}
    ranks = {port_rank: "port", 1 - port_rank: "jax"}
    for rank in (1, 0):
        ck, _ = PKGS[ranks[rank]]
        ck.CheckpointManager(d, process_index=rank, process_count=2,
                             commit_timeout=0 if rank else 5).save(
            6, _tree(ranks[rank], 8), meta=dict(meta, rank=rank))
    step_dir = os.path.join(d, "step-00000006")
    markers = [json.loads(_files(step_dir)["done-p%05d.json" % r])
               for r in (0, 1)]
    assert sorted(markers[0]) == sorted(markers[1])
    assert [m["process"] for m in markers] == [0, 1]
    w, n = _arrays(8)
    for pkg, (ck, _) in sorted(PKGS.items()):
        s, got, got_meta = ck.CheckpointManager(d, process_count=1).restore(
            _tree(pkg, 0), return_meta=True)
        assert s == 6
        assert _np(got["w"]).tobytes() == w.tobytes()
        assert int(_np(got["n"])) == int(n)
        assert got_meta["data_iter_parts"] == {"0": meta["data_iter"],
                                               "1": meta["data_iter"]}
        assert got_meta["rank"] == 0


def _shard_save(d, data, count, pad0):
    """Each of ``count`` ranks saves its rows of ``data`` zero-padded to
    ``pad0`` rows, and a replicated leaf."""
    rows = pad0 // count
    padded = np.zeros((pad0,) + data.shape[1:], data.dtype)
    padded[:len(data)] = data
    for rank in reversed(range(count)):
        blk = torch.from_numpy(padded[rank * rows:(rank + 1) * rows].copy())
        state = {"m": tck.Shard(blk, padded.shape,
                                (rank * rows, (rank + 1) * rows), rank,
                                count, spec="PartitionSpec('dp',)"),
                 "r": torch.arange(3)}
        tck.CheckpointManager(d, process_index=rank, process_count=count,
                              commit_timeout=0 if rank else 5).save(
            1, state)
    return padded


def test_shard_leaves_write_rows_and_read_back_any_split(tmp_path):
    d = str(tmp_path / "shared")
    data = np.random.RandomState(0).normal(size=(13, 3)).astype(np.float32)
    padded = _shard_save(d, data, count=2, pad0=14)
    step_dir = os.path.join(d, "step-00000001")
    manifest = json.loads(_files(step_dir)["manifest.json"])
    entry = manifest["arrays"][0]
    assert entry["shape"] == [14, 3] and entry["spec"] == "PartitionSpec('dp',)"
    assert [(f["file"], f["index"], f["part_shape"]) for f in entry["files"]] \
        == [("arr_00000.shard000.bin", [[0, 7], [None, None]], [7, 3]),
            ("arr_00000.shard001.bin", [[7, 14], [None, None]], [7, 3])]
    # the JAX package assembles the whole padded leaf
    _, got = jck.CheckpointManager(d, process_count=1).restore(
        {"m": np.zeros((14, 3), np.float32), "r": np.zeros(3, np.int64)})
    assert np.asarray(got["m"]).tobytes() == padded.tobytes()
    # the port reads any rows, at 3 ranks padded to 15 rows (elastic)
    like_rows = [(0, 5), (5, 10), (10, 15)]
    mgr = tck.CheckpointManager(d, process_count=1)
    blocks = []
    for r, rows in enumerate(like_rows):
        like = {"m": tck.Shard(torch.zeros(5, 3), (15, 3), rows, r, 3),
                "r": torch.zeros(3, dtype=torch.int64)}
        _, got = mgr.restore(like, elastic={"m": 13, "r": None})
        blocks.append(got["m"].numpy())
    want = np.zeros((15, 3), np.float32)
    want[:13] = data
    assert np.concatenate(blocks).tobytes() == want.tobytes()
    # rows 0..7 need rank 0's file alone
    os.unlink(os.path.join(step_dir, "arr_00000.shard001.bin"))
    like = {"m": tck.Shard(torch.zeros(7, 3), (14, 3), (0, 7), 0, 2),
            "r": torch.zeros(3, dtype=torch.int64)}
    _, got = mgr.restore(like)
    assert got["m"].numpy().tobytes() == padded[:7].tobytes()
    like["m"] = tck.Shard(torch.zeros(7, 3), (14, 3), (7, 14), 1, 2)
    with pytest.warns(UserWarning, match="corrupt"), \
            pytest.raises(tck.CheckpointError, match="no intact"):
        mgr.restore(like)


def test_one_process_refuses_part_of_a_sharded_leaf(tmp_path):
    blk = tck.Shard(torch.zeros(2, 3), (4, 3), (2, 4), 1, 2)
    with pytest.raises(tck.CheckpointError, match="process_count=2"):
        tck.CheckpointManager(str(tmp_path), process_count=1).save(
            1, {"m": blk})
    assert tck.CheckpointManager(str(tmp_path)).steps() == []
    with pytest.raises(tck.CheckpointError, match="block it owns"):
        tck.CheckpointManager(str(tmp_path), process_index=0,
                              process_count=2, commit_timeout=0).save(
            1, {"m": blk})
