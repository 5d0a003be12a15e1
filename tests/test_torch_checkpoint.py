"""The port's ``CheckpointManager`` against the JAX package's
(``parallel/checkpoint.py``), on the CPU.

A tree of f32, bf16, int32, int8 and uint8 leaves in nested dicts,
tuples and lists round-trips exactly; either package's manager writes
the same files (manifest and payloads byte for byte) and restores the
other's checkpoints exactly, a leaf the JAX package wrote one file per
shard included.  The failure drills: a flipped payload byte
falls back to the previous step with a warning; a leftover
``.tmp-step-*`` directory is never listed and is swept by the next save;
``keep_last`` retires old steps; more than one process raises naming
ROADMAP A8; ``request_checkpoint()`` makes an attached step save at its
next boundary, and ``every=`` on the schedule.
"""
import json
import os
import signal

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.parallel import checkpoint as jck

from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch import initializer
from incubator_mxnet_tpu_torch.parallel import checkpoint as tck
from incubator_mxnet_tpu_torch.parallel import train_step as tstep


def _arrays(seed):
    """Numpy leaves, the bf16 one as ml_dtypes."""
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "bf16": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
        "i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (2, 2)).astype(np.int32),
        "i8": rng.randint(-128, 127, (7,)).astype(np.int8),
        "u8": rng.randint(0, 255, (4, 3)).astype(np.uint8),
        "scalar": np.float32(rng.normal()),
    }


def _tree(a, leaf):
    """The same nested structure around converted leaves."""
    return {"w": [leaf(a["f32"]), {"b": leaf(a["bf16"]),
                                   "c": (leaf(a["i32"]), leaf(a["i8"]))}],
            "u": leaf(a["u8"]), "s": leaf(a["scalar"]), "none": None}


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(leaf):
    """Dtype name and raw bytes of a tensor or array leaf (numpy, jax)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes()
        leaf = t.numpy()
    a = np.asarray(leaf)
    return a.dtype.name, a.tobytes()


def _like_torch(seed=99):
    return _tree(_arrays(seed), _torch)


def test_round_trip_nested_tree(tmp_path):
    src = _tree(_arrays(0), _torch)
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(5, src, meta={"note": "x"})
    step, got, meta = mgr.restore(_like_torch(), return_meta=True)
    assert step == 5 and meta == {"note": "x"} and got["none"] is None
    flat_s, flat_g = tck._flatten(src), tck._flatten(got)
    assert [k for k, _ in flat_s] == [k for k, _ in flat_g]
    assert "['w'][1]['c'][1]" in [k for k, _ in flat_s]
    for (_, s), (_, g) in zip(flat_s, flat_g):
        assert isinstance(g, torch.Tensor) and _bits(g) == _bits(s)


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def test_same_files_from_either_package(tmp_path):
    a = _arrays(1)
    meta = {"topology": {"mesh": None}, "data_iter": {"iter": "X", "b": 3}}
    jpath = jck.CheckpointManager(str(tmp_path / "j")).save(
        7, _tree(a, jnp.asarray), meta=meta)
    tpath = tck.CheckpointManager(str(tmp_path / "t")).save(
        7, _tree(a, _torch), meta=meta)
    assert os.path.basename(jpath) == os.path.basename(tpath) == \
        "step-00000007"
    assert _files(jpath) == _files(tpath)
    entry = json.loads(_files(tpath)["manifest.json"])["arrays"][2]
    assert entry["key"] == "['w'][0]" and entry["dtype"] == "float32"
    assert entry["files"][0]["checksum"].startswith("crc32:")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    a = _arrays(2)
    d = str(tmp_path)
    if writer == "jax":
        jck.CheckpointManager(d).save(3, _tree(a, jnp.asarray))
        step, got = tck.CheckpointManager(d).restore(_like_torch())
    else:
        tck.CheckpointManager(d).save(3, _tree(a, _torch))
        step, got = jck.CheckpointManager(d).restore(
            _tree(_arrays(99), jnp.asarray))
    assert step == 3
    want = tck._flatten(_tree(a, np.asarray))
    got = tck._flatten(got)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert _bits(g) == _bits(w)


def test_flipped_byte_falls_back_to_previous_step(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(_arrays(1), _torch))
    mgr.save(2, _tree(_arrays(2), _torch))
    path = os.path.join(str(tmp_path), "step-00000002", "arr_00002.bin")
    data = bytearray(open(path, "rb").read())
    data[3] ^= 0x10
    open(path, "wb").write(bytes(data))
    with pytest.warns(UserWarning, match="step-00000002 is corrupt.*checksum"):
        step, got = mgr.restore(_like_torch())
    assert step == 1
    assert _bits(got["u"]) == _bits(_torch(_arrays(1)["u8"]))
    with pytest.raises(tck.CheckpointCorruptError, match="checksum"):
        mgr.restore(_like_torch(), step=2)


def test_stale_staging_is_invisible_and_swept(tmp_path):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d)
    mgr.save(1, _tree(_arrays(1), _torch))
    stale = os.path.join(d, ".tmp-step-00000002")
    os.makedirs(stale)
    open(os.path.join(stale, "arr_00000.bin"), "wb").write(b"torn")
    assert mgr.steps() == [1] and mgr.latest_committed() == 1
    assert mgr.restore(_like_torch())[0] == 1
    mgr.save(2, _tree(_arrays(2), _torch))
    assert not os.path.exists(stale)
    assert mgr.steps() == [1, 2] and mgr.latest_step() == 2


def test_keep_last_retires_old_steps(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep_last=2)
    for s in range(1, 5):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.steps() == [3, 4]
    assert float(mgr.restore({"x": torch.zeros(2)})[1]["x"][0]) == 4.0
    with pytest.raises(ValueError, match="keep_last"):
        tck.CheckpointManager(str(tmp_path), keep_last=0)


def test_multi_process_waits_for_a8(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tck.CheckpointManager(str(tmp_path), process_count=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tck.CheckpointManager(str(tmp_path), process_index=1)


def test_nothing_to_restore_and_structure_change(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    with pytest.raises(tck.CheckpointError, match="no checkpoints"):
        mgr.restore({"x": torch.zeros(2)})
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(tck.CheckpointError, match="no intact checkpoint"):
        with pytest.warns(UserWarning, match="corrupt"):
            mgr.restore({"x": torch.zeros(2), "y": torch.zeros(1)})
    with pytest.raises(tck.CheckpointTopologyError, match="shape"):
        mgr.restore({"x": torch.zeros(3)})


def test_elastic_leaf_is_cut_and_padded(tmp_path):
    """A leaf marked with its logical leading dim re-pads across widths
    (the reference's ZeRO-1 restore); unmarked, the mismatch refuses."""
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, {"m": torch.arange(8.0).reshape(4, 2)})
    _, got = mgr.restore({"m": torch.zeros(6, 2)}, elastic={"m": 3})
    assert got["m"].tolist() == [[0, 1], [2, 3], [4, 5], [0, 0], [0, 0],
                                 [0, 0]]
    with pytest.raises(tck.CheckpointTopologyError, match="ZeRO"):
        mgr.restore({"m": torch.zeros(6, 2)})


def _small_step():
    net = tnn.Dense(3, in_units=4, device="cpu")
    initializer.initialize(net, generator=torch.Generator().manual_seed(0))
    return tstep.make_train_step(net, tloss.SoftmaxCrossEntropyLoss(),
                                 learning_rate=0.1, momentum=0.9,
                                 device="cpu")


def test_request_and_schedule_save_at_step_boundary(tmp_path):
    step = _small_step()
    mgr = step.attach_checkpoint(str(tmp_path), every=3)
    x, y = torch.ones(2, 4), torch.tensor([0.0, 2.0])
    step(x, y)
    assert mgr.steps() == []
    tck.request_checkpoint()
    assert tck.checkpoint_requested(since=step._ckpt_seen_request)
    step(x, y)
    assert mgr.steps() == [2]
    step(x, y)  # crosses the every=3 boundary
    assert mgr.steps() == [2, 3]
    step(x, y)  # the request was honored once
    assert mgr.steps() == [2, 3]
    # the preemption hook only bumps the request sequence
    prev = tck.install_preemption_hook(signals=(signal.SIGUSR1,))
    try:
        seq = tck.request_seq()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert tck.request_seq() == seq + 1
    finally:
        assert tck.uninstall_preemption_hook(signals=(signal.SIGUSR1,)) == \
            {signal.SIGUSR1: prev[signal.SIGUSR1]}
    step(x, y)
    assert mgr.steps() == [2, 3, 5]
    with pytest.raises(ValueError, match="iterator-state protocol"):
        step.attach_checkpoint(str(tmp_path), data_iter=object())


def test_sharded_jax_leaf_restores_whole(tmp_path):
    """A leaf the JAX manager wrote one file per distinct shard (a
    dp-sharded array on the 8-device CPU mesh) is assembled whole."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    a = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    leaf = jax.device_put(a, NamedSharding(mesh, PartitionSpec("dp")))
    path = jck.CheckpointManager(str(tmp_path)).save(1, {"m": leaf})
    files = json.loads(open(os.path.join(path, "manifest.json")).read())[
        "arrays"][0]["files"]
    assert len(files) == 8
    _, got = tck.CheckpointManager(str(tmp_path)).restore(
        {"m": torch.zeros(16, 3)})
    np.testing.assert_array_equal(got["m"].numpy(), a)
