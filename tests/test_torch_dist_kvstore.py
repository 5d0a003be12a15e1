"""The port's dist kvstore over ``torch.distributed``: the checks of the
reference's ``tests/dist_worker.py`` over 2 ranks (gloo on the CPU), the
``gluon.Trainer`` over a ``dist_sync`` store against the JAX package,
and ``example/distributed_training/cifar10_dist_torch.py`` small.

One job of 2 ranks (``tools/launch.py``, ``tests/torch_dist_worker.py``,
which imports no JAX) runs everything; each rank pushes rank-dependent
values and dumps what it saw:

- rank 0's ``init`` wins everywhere; a push sums exactly; an sgd
  optimizer on the store (lr 0.1) makes the same update on every rank;
  all three bit for bit across the ranks;
- a two-key push sums exactly in exactly one ``all_reduce``;
- the Trainer (``Dense(2)``, L2 loss, sgd lr 0.05, 3 steps, each rank
  its own batches) from the JAX net's weights: the replicas equal bit for
  bit, moved, and within 1e-6 relative of the reference ``Trainer.update``
  fed each step the ranks' gradients from the same weights summed in
  rank order;
- the cifar10 example (64 samples, batch 8, 2 epochs): finite losses and
  trained parameters equal bit for bit across the ranks;
- ``train_imagenet_torch.py --kv-store dist_sync_device`` over an
  8-record RecordIO shard (a thumbnail ResNet, global batch 4): in one
  epoch each rank reads its own half of the records, and the ranks'
  losses over 3 batches are finite and equal bit for bit.
"""
import json
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd

import torch_dist_launch

N = 2
STEPS = 3


def _trainer_inputs():
    jmx.random.seed(0)
    net = jgluon.nn.Dense(2, in_units=3)
    net.initialize(init=jmx.init.Xavier())
    inputs = {"trainer.w%d" % i: p.data().asnumpy()
              for i, p in enumerate(net.collect_params().values())}
    for r in range(N):
        rs = np.random.RandomState(100 + r)
        for s in range(STEPS):
            inputs["trainer.x%d_%d" % (s, r)] = \
                rs.uniform(-1, 1, (4, 3)).astype(np.float32)
            inputs["trainer.y%d_%d" % (s, r)] = \
                rs.uniform(-1, 1, (4, 2)).astype(np.float32)
    return inputs


def _reference_trainer(inputs):
    """The reference's ``Trainer.update`` fed, each step, the ranks'
    gradients from the same weights summed in rank order."""
    import jax.numpy as jnp

    net = jgluon.nn.Dense(2, in_units=3)
    net.initialize()
    params = list(net.collect_params().values())
    for i, p in enumerate(params):
        p.set_data(nd.array(inputs["trainer.w%d" % i]))
    trainer = jgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05}, kvstore=None)
    loss_fn = jgluon.loss.L2Loss()
    for s in range(STEPS):
        total = None
        for r in range(N):
            x = nd.array(inputs["trainer.x%d_%d" % (s, r)])
            y = nd.array(inputs["trainer.y%d_%d" % (s, r)])
            with jag.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            g = [p.grad().asnumpy().copy() for p in params]
            total = g if total is None else [a + b for a, b in zip(total, g)]
        for p, g in zip(params, total):
            p.grad()._data = jnp.asarray(g)
        trainer.update(4)
    return [p.data().asnumpy() for p in params]


def _write_shard(prefix, records=8):
    """``records`` 36x36 ``.npy`` images, record i labelled i."""
    from incubator_mxnet_tpu_torch import recordio

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(records):
        img = rng.randint(0, 255, (36, 36, 3)).astype(np.uint8)
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".npy"))
    rec.close()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dist_kv")
    inputs = _trainer_inputs()
    np.savez(os.path.join(str(outdir), "inputs.npz"), **inputs)
    _write_shard(os.path.join(str(outdir), "shard"))
    proc = torch_dist_launch.start("kvstore", outdir)
    try:
        ref = _reference_trainer(inputs)
    except BaseException:
        proc.kill()
        raise
    return torch_dist_launch.finish(proc, outdir), ref


def test_world(job):
    ranks = job[0]
    assert sorted(int(w["rank"]) for w in ranks) == list(range(N))
    assert all(int(w["nw"]) == N for w in ranks)


def test_init_rank0_wins(job):
    for w in job[0]:
        np.testing.assert_array_equal(w["init"], np.full((4, 3), 7.0))


def test_push_exact_sum(job):
    expect = np.full((4, 3), sum(range(1, N + 1)), np.float32)
    for w in job[0]:
        np.testing.assert_array_equal(w["sum"], expect)


def test_optimizer_update_identical(job):
    expect = np.full((5, 2), 1.0 - 0.1 * sum(range(1, N + 1)), np.float32)
    for w in job[0]:
        np.testing.assert_allclose(w["opt"], expect, rtol=1e-6)


def test_bitwise_identical_across_ranks(job):
    a, b = job[0]
    for k in ("init", "sum", "opt", "mk1", "mk2"):
        assert a[k].tobytes() == b[k].tobytes(), k


def test_multi_key_push_is_one_all_reduce(job):
    for w in job[0]:
        assert json.loads(str(w["mk_counts"])) == {"all_reduce": 1}
        np.testing.assert_array_equal(
            w["mk1"], np.full((3, 2), sum(range(1, N + 1)), np.float32))
        np.testing.assert_array_equal(
            w["mk2"], np.full((5,), 10.0 * sum(range(1, N + 1)), np.float32))


def test_trainer_matches_reference(job):
    (a, b), ref = job
    assert a["trained_w"].tobytes() == b["trained_w"].tobytes()
    assert a["trained_b"].tobytes() == b["trained_b"].tobytes()
    start = _trainer_inputs()["trainer.w0"]
    assert np.abs(a["trained_w"] - start).max() > 1e-3
    np.testing.assert_allclose(a["trained_w"], ref[0], rtol=1e-6)
    np.testing.assert_allclose(a["trained_b"], ref[1], rtol=1e-6)


def test_cifar10_example(job):
    a, b = job[0]
    assert len(a["cifar_losses"]) == 2 * (64 // N // 8)
    assert np.all(np.isfinite(a["cifar_losses"]))
    keys = [k for k in a if k.startswith("cifar_p")]
    assert len(keys) == 10   # 2 convs and the dense (w, b), 2 BNs (g, b)
    for k in keys:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_trainer_reads_its_part_of_the_recordio(job):
    a, b = job[0]
    seen = [sorted(w["rec_labels"].astype(int).tolist()) for w in (a, b)]
    assert all(len(s) == 4 for s in seen), seen
    assert sorted(seen[0] + seen[1]) == list(range(8)), seen


def test_trainer_ranks_agree_over_the_recordio(job):
    a, b = job[0]
    assert len(a["rec_losses"]) == 3
    assert np.all(np.isfinite(a["rec_losses"]))
    assert a["rec_losses"].tobytes() == b["rec_losses"].tobytes()
