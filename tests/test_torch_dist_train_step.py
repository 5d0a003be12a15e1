"""The port's data-parallel ``TrainStep`` at dp=2 against the JAX
package's ``make_train_step(mesh=make_mesh({"dp": 2}))``.

One job of 2 ranks over gloo on the CPU (``tools/launch_torch.py``,
``tests/torch_dist_worker.py``, which imports no JAX) runs every case
and then every eager collective once (held exact);
the parent builds each JAX net, hands its initial weights and the global
batches to the ranks through an ``.npz``, and runs the reference's dp=2
step over two of its 8 CPU devices meanwhile.  Each rank steps on its
half of each global batch.  Cases, 3 steps each at lr 0.01, sgd with
momentum 0.9, wd 1e-4, ``multi_precision``:

- an MLP with a ragged ``Dense(13)`` head (13 rows pad to 14 under
  ZeRO-1), ``zero`` 0 and 1;
- the cifar10 example's conv-BN net with ``zero=1``: stock BatchNorm
  takes the global batch's statistics, so the running stats match the
  reference's; the same net stepped on rank 0's half alone (the
  reference, one device) misses that tolerance, which shows the sync;
- ``BasicBlockV1(ghost_bn=4)`` (the GhostBN downsample, the fused exit)
  with a dynamic loss scale and ``zero=1``: ghost groups of 4 inside
  each rank's 8 images, the running stats merged over the ranks.

Tolerance: losses, parameters and running stats within 1e-5 relative
(plus 1e-7 absolute for entries near zero) of the reference's; the two
ranks' losses, parameters and running stats equal bit for bit.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.model_zoo.vision.resnet import BasicBlockV1
from incubator_mxnet_tpu.parallel import make_mesh as jmesh
from incubator_mxnet_tpu.parallel import make_train_step as jmake

import torch_dist_launch

OPT = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9, wd=1e-4,
           multi_precision=True)
CASES = [
    dict(name="mlp_z0", net="mlp", shape=(8, 10), classes=13, zero=0,
         opt=OPT),
    dict(name="mlp_z1", net="mlp", shape=(8, 10), classes=13, zero=1,
         opt=OPT),
    dict(name="convbn_z1", net="convbn", image=8, shape=(8, 3, 8, 8),
         classes=10, zero=1, opt=OPT),
    dict(name="block_z1", net="block", image=12, shape=(16, 3, 12, 12),
         classes=10, zero=1, opt=dict(OPT, loss_scale="dynamic")),
]
STEPS = 3
RTOL, ATOL = 1e-5, 1e-7


def _jax_cifar():
    spec = importlib.util.spec_from_file_location(
        "cifar10_dist", os.path.join(torch_dist_launch.REPO, "example",
                                     "distributed_training",
                                     "cifar10_dist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_net(case):
    jmx.random.seed(0)
    if case["net"] == "mlp":
        net = jnn.HybridSequential()
        net.add(jnn.Dense(16, in_units=10, activation="relu"),
                jnn.Dense(13, in_units=16))
    elif case["net"] == "convbn":
        net = _jax_cifar().build_net()
    else:
        net = jnn.HybridSequential()
        net.add(BasicBlockV1(128, 1, downsample=True, in_channels=3,
                             ghost_bn=4),
                jnn.GlobalAvgPool2D(), jnn.Dense(10))
    net.initialize(init=jmx.init.Xavier())
    if case["net"] != "mlp":
        net.shape_init((1, 3, case["image"], case["image"]))
    return net


def _batches(case):
    rng = np.random.RandomState(sum(map(ord, case["name"])))
    return [(rng.normal(size=case["shape"]).astype(np.float32),
             rng.randint(0, case["classes"], case["shape"][0])
             .astype(np.float32)) for _ in range(STEPS)]


def _values(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def _reference(case, batches, mesh):
    net = _jax_net(case)
    step = jmake(net, jgluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                 zero=case["zero"] if mesh is not None else 0, lint="off",
                 **case["opt"])
    losses = [float(step(nd.array(x, dtype="float32"),
                         nd.array(y, dtype="float32")).asnumpy())
              for x, y in batches]
    return losses, _values(net), list(net.collect_params().keys())


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dist_step")
    inputs, batches = {}, {}
    for case in CASES:
        for i, w in enumerate(_values(_jax_net(case))):
            inputs["%s.w%d" % (case["name"], i)] = w
        batches[case["name"]] = _batches(case)
        for s, (x, y) in enumerate(batches[case["name"]]):
            inputs["%s.x%d" % (case["name"], s)] = x
            inputs["%s.y%d" % (case["name"], s)] = y
    np.savez(os.path.join(str(outdir), "inputs.npz"), **inputs)
    spec = [dict(name=c["name"], net=c["net"], image=c.get("image", 0),
                 zero=c["zero"], opt=c["opt"], steps=STEPS) for c in CASES]
    with open(os.path.join(str(outdir), "cases.json"), "w") as f:
        json.dump(spec, f)
    proc = torch_dist_launch.start("step", outdir)
    try:
        mesh = jmesh({"dp": 2}, devices=jax.devices()[:2])
        ref = {c["name"]: _reference(c, batches[c["name"]], mesh)
               for c in CASES}
        # the conv-BN net stepped on rank 0's half alone, one device
        half = [(x[:4], y[:4]) for x, y in batches["convbn_z1"]]
        ref["convbn_rank0"] = _reference(CASES[2], half, None)
    except BaseException:
        proc.kill()
        raise
    ranks = torch_dist_launch.finish(proc, outdir)
    return ranks, ref


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_dp_step_matches_reference(job, case):
    ranks, ref = job
    losses, params, names = ref[case]
    r0, r1 = ranks
    np.testing.assert_allclose(r0[case + ".loss"], losses, rtol=RTOL,
                               atol=ATOL)
    for i, (name, want) in enumerate(zip(names, params)):
        np.testing.assert_allclose(r0["%s.p%d" % (case, i)], want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_replicas_bit_identical(job, case):
    r0, r1 = job[0]
    assert r0[case + ".loss"].tobytes() == r1[case + ".loss"].tobytes()
    assert float(r0[case + ".scale"]) == float(r1[case + ".scale"])
    n = len(job[1][case][1])
    for i in range(n):
        key = "%s.p%d" % (case, i)
        assert r0[key].tobytes() == r1[key].tobytes(), key


def test_stock_bn_needs_the_sync(job):
    """The running stats of the conv-BN net match the reference's dp
    step; those of rank 0's half alone miss that tolerance."""
    ranks, ref = job
    _, want, names = ref["convbn_z1"]
    _, alone, _ = ref["convbn_rank0"]
    stats = [i for i, n in enumerate(names) if "running" in n]
    assert len(stats) == 4
    for i in stats:
        got = ranks[0]["convbn_z1.p%d" % i]
        np.testing.assert_allclose(got, want[i], rtol=RTOL, atol=ATOL)
        assert not np.allclose(alone[i], want[i], rtol=RTOL, atol=ATOL), \
            names[i]


def test_collectives_per_step(job):
    """zero=0: one all_reduce a step (gradients, loss and the ghost
    stats coalesced; all f32).  zero=1: one reduce_scatter, one small
    all_reduce and one all_gather a step; stock BN adds an all_gather in
    its forward and an all_reduce in its backward per layer.  The batch
    check gathers once per batch shape."""
    r0 = job[0][0]
    counts = {c["name"]: json.loads(str(r0[c["name"] + ".collectives"]))
              for c in CASES}
    assert counts["mlp_z0"] == {"all_gather": 1, "all_reduce": STEPS}
    assert counts["mlp_z1"] == {"all_gather": 1 + STEPS,
                                "reduce_scatter": STEPS,
                                "all_reduce": STEPS}
    assert counts["block_z1"] == counts["mlp_z1"]
    assert counts["convbn_z1"] == {"all_gather": 1 + 3 * STEPS,
                                   "reduce_scatter": STEPS,
                                   "all_reduce": 3 * STEPS}


def test_collectives_over_the_ranks(job):
    """Every eager collective of ``parallel/collectives.py`` over the two
    ranks, exact."""
    import torch_dist_worker

    for r, got in enumerate(job[0]):
        for k, want in torch_dist_worker.collectives_expected(r, 2).items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
