"""``example/image_classification/train_imagenet_torch.py`` on the CPU,
and checkpoints of stock-BN train steps crossing between the packages.

The trainer (``main([..., "--device", "cpu"])``) runs a width-reduced
ResNet v1 (``ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
thumbnail=True)``, put in the zoo under a test name) and the zoo's
``resnet18_v1``:

- from the synthetic resident batch: finite losses, one per batch, and
  the reference's log line every 10 batches;
- from a 10-record RecordIO shard of 36x36 ``.npy`` images (batch 4,
  random 32x32 crops, so the epoch ends and the iterator resets);
- ``--kv-store dist_sync_device`` without a launcher (one process, a dp
  mesh of one) takes the steps of ``--kv-store device`` bit for bit (the
  two-process run, each rank reading its part of a RecordIO shard, is
  ``tests/test_torch_dist_kvstore.py``'s).

Checkpoints: a stock-BN v1 net and a v2 net (whose input BN has gamma
and beta without gradient, in the aux set) train 2 steps on one side,
save, restore into the other package's fresh ``TrainStep`` (another
seed's weights) and both take 2 more steps.  Every restored leaf equals
the writer's bit for bit under the same tree keys; the next losses and
the final parameters agree within 1e-4 (f32, lr 0.01: these thumbnail
nets have no max pool, and ``test_torch_zoo.py`` holds them over 3 steps
at 1e-4).
"""
import importlib.util
import logging
import os

import jax
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from incubator_mxnet_tpu.parallel import make_train_step as jmake

from incubator_mxnet_tpu_torch import convert, gluon
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.parallel import checkpoint as tck
from incubator_mxnet_tpu_torch.parallel import make_train_step

from test_torch_zoo import OPT, build_pair

SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "example",
                      "image_classification", "train_imagenet_torch.py")
SMALL = ["--device", "cpu", "--batch-size", "4", "--image-shape", "3,32,32",
         "--num-classes", "10", "--dtype", "float32"]


def _trainer():
    spec = importlib.util.spec_from_file_location("train_imagenet_torch",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(monkeypatch):
    def tiny_resnet(classes, device):
        return tres.ResNetV1(tres.BasicBlockV1, [1, 1, 1, 1],
                             [8, 8, 16, 32, 64], classes=classes,
                             thumbnail=True, device=device)

    monkeypatch.setattr(vision, "tiny_resnet", tiny_resnet, raising=False)
    return "tiny_resnet"


def test_trainer_synthetic_batch(tiny, caplog):
    caplog.set_level(logging.INFO)
    losses = _trainer().main(SMALL + ["--network", tiny,
                                      "--num-batches", "12"])
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("batch ")]
    assert len(lines) == 1 and lines[0].startswith("batch 10  loss ")
    assert lines[0].endswith(" img/s")


def test_trainer_default_zoo_net():
    losses = _trainer().main(SMALL + ["--network", "resnet18_v1",
                                      "--num-batches", "2"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_trainer_from_recordio(tiny, tmp_path):
    prefix = str(tmp_path / "shard")
    rec = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(10):
        img = rng.randint(0, 255, (36, 36, 3)).astype(np.uint8)
        rec.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 10), i, 0),
                                       img, img_fmt=".npy"))
    rec.close()
    losses = _trainer().main(SMALL + [
        "--network", tiny, "--num-batches", "4",
        "--data-train", prefix + ".rec", "--data-train-idx", prefix + ".idx"])
    assert len(losses) == 4 and np.all(np.isfinite(losses))


def test_dist_sync_device_names_a8(tiny):
    """ROADMAP A8's route: a dp mesh over the launched processes, here
    one."""
    args = SMALL + ["--network", tiny, "--num-batches", "3"]
    want = _trainer().main(args)
    got = _trainer().main(args + ["--kv-store", "dist_sync_device"])
    assert got == want


def _nets(version):
    block = "BasicBlockV%d" % version
    cls = "ResNetV%d" % version

    def build(mod, **kw):
        return lambda: getattr(mod, cls)(
            getattr(mod, block), [1, 1, 1, 1], [8, 8, 16, 32, 64],
            classes=10, thumbnail=True, **kw)

    return build(jres), build(tres, device="cpu")


def _jax_state(step):
    flat, _ = jax.tree_util.tree_flatten_with_path(step._checkpoint_state())
    return [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in flat]


def _port_state(step):
    return [(k, v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tck._flatten(step._checkpoint_state())]


def _batches(n=4, shape=(2, 3, 16, 16)):
    rng = np.random.RandomState(11)
    return [(rng.normal(size=shape).astype(np.float32),
             rng.randint(0, 10, shape[0]).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stock_bn_checkpoints_cross(tmp_path, version, writer):
    d = str(tmp_path / "ckpt")
    shape = (2, 3, 16, 16)
    jbuild, tbuild = _nets(version)
    jnet, tnet = build_pair(jbuild, tbuild, shape, seed=3)
    jnet5, tnet5 = build_pair(jbuild, tbuild, shape, seed=5)
    batches = _batches()

    def jstep_(step, x, y):
        return float(step(nd.array(x), nd.array(y)).asnumpy())

    def tstep_(step, x, y):
        return step(torch.from_numpy(x), torch.from_numpy(y)).item()

    def port_step(net):
        return make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               device="cpu", **OPT)

    if writer == "jax":
        jstep = jmake(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                      lint="off", **OPT)
        for x, y in batches[:2]:
            jstep_(jstep, x, y)
        jstep.save_checkpoint(d)
        tstep, tnet = port_step(tnet5), tnet5
        assert tstep.restore_checkpoint(d) == 2
    else:
        tstep = port_step(tnet)
        for x, y in batches[:2]:
            tstep_(tstep, x, y)
        tstep.save_checkpoint(d)
        jnet = jnet5
        jstep = jmake(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                      lint="off", **OPT)
        assert jstep.restore_checkpoint(d) == 2
    want, got = _jax_state(jstep), _port_state(tstep)
    assert [k for k, _ in want] == [k for k, _ in got]
    n_aux = len([k for k, _ in got if k.startswith("['aux']")])
    # v1: 11 BNs' running stats; v2: 10 BNs' and the input BN's gamma and
    # beta
    assert n_aux == len(tstep._aux) == len(jstep._aux) == 22
    for (k, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for x, y in batches[2:]:
        np.testing.assert_allclose(tstep_(tstep, x, y), jstep_(jstep, x, y),
                                   rtol=0, atol=1e-4)
    params = list(jnet.collect_params().values())
    for p, (name, t) in zip(params, convert.ordered_tensors(tnet)):
        np.testing.assert_allclose(t.detach().numpy(), p.data().asnumpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
