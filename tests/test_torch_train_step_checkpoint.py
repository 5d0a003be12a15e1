"""Resumable train steps: the port's ``TrainStep`` checkpoints against
its own uninterrupted run and against the JAX package's ``TrainStep``.

The net is the small ghost-BN ResNet v1 of ``test_torch_resnet.py``
(64 px), the optimizer ``test_torch_train_step.py``'s: sgd with
momentum 0.9, lr 0.01, wd 1e-4, ``multi_precision`` master weights and
a dynamic loss scale, f32 compute on the CPU.

- Fed by the port's ``ImageRecordUInt8Iter`` (10 records of uint8
  images, batch 4, shuffled and mirrored, so 3 batches an epoch): 4
  uninterrupted steps equal 2 steps, a checkpoint with the iterator's
  position, a restore into a fresh net, step and iterator, and 2 more
  steps, bit for bit in losses and in the whole state.
- A checkpoint written by the JAX ``TrainStep`` after 2 steps restores
  into the port's, and the reverse: every leaf of the restored state
  (params, running stats, optimizer state, PRNG key, step counter, loss
  scale) equals the writer's bit for bit, under the same tree keys.
  Both then take the same next 2 steps within
  ``test_three_steps_match_reference``'s 1e-4 (absolute, losses and
  parameters).  Those two steps run at lr 1e-3: the two packages' f32
  rounding differs by ~1e-6, and at lr 0.01 (or 0.003) that flips a
  ReLU or max-pool near-tie by the fourth (third) step of this sequence
  and moves the parameters by 1.6e-3 in an uninterrupted run of both
  packages alike; at 1e-3 they stay within 3e-6 over all four steps.
"""
import jax
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.parallel import make_train_step as jmake

from incubator_mxnet_tpu_torch import convert, cpu, initializer
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.parallel import checkpoint as tck
from incubator_mxnet_tpu_torch.parallel import train_step as tstep

from test_torch_resnet import CHANNELS, IMAGE, LAYERS, build_pair
from test_torch_train_step import OPT, _batches


def _port_net(seed):
    net = tres.ResNetV1(tres.BottleneckV1, LAYERS, CHANNELS, classes=10,
                        ghost_bn=2, device="cpu")
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator().manual_seed(seed))
    return net


def _port_step(net):
    return tstep.make_train_step(net, tloss.SoftmaxCrossEntropyLoss(),
                                 device="cpu", **OPT)


def _shard(tmp_path, n=10):
    prefix = str(tmp_path / "shard")
    rec = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, (IMAGE, IMAGE, 3)).astype(np.uint8)
        rec.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 10), i, 0),
                                       img, img_fmt=".npy"))
    rec.close()
    return prefix


def _iter(prefix):
    return tio.ImageRecordUInt8Iter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=(3, IMAGE, IMAGE), batch_size=4, shuffle=True,
        rand_mirror=True, preprocess_threads=2, prefetch_buffer=2, seed=0,
        ctx=cpu())


def _take(it):
    try:
        return it.next()
    except StopIteration:
        it.reset()
        return it.next()


def _state(step):
    return [(k, v.detach().clone() if isinstance(v, torch.Tensor)
             else v.copy())
            for k, v in tck._flatten(step._checkpoint_state())]


def test_record_fed_resume_is_bit_identical(tmp_path):
    prefix = _shard(tmp_path)
    d = str(tmp_path / "ckpt")
    step, it = _port_step(_port_net(3)), _iter(prefix)
    losses = []
    for i in range(4):
        b = _take(it)
        losses.append(step(b.data[0], b.label[0]))
        if i == 1:
            step.save_checkpoint(d, data_iter=it)
    it.close()
    want = _state(step)

    step2, it2 = _port_step(_port_net(8)), _iter(prefix)
    assert not torch.equal(step2._gp[0], step._gp[0])
    assert step2.restore_checkpoint(d, data_iter=it2) == 2
    losses2 = []
    for _ in range(2):
        b = _take(it2)
        losses2.append(step2(b.data[0], b.label[0]))
    it2.close()
    assert all(torch.isfinite(v) for v in losses)
    for a, b in zip(losses[2:], losses2):
        assert torch.equal(a, b)
    got = _state(step2)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (k, a), (_, b) in zip(want, got):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) \
            else np.array_equal(a, b)
        assert same, k
    assert step2.step_count == 4 and step2.skipped_steps == 0
    assert step2._step_count == 4


def test_restore_without_iterator_state_is_refused(tmp_path):
    prefix = _shard(tmp_path)
    d = str(tmp_path / "ckpt")
    step, it = _port_step(_port_net(3)), _iter(prefix)
    b = _take(it)
    step(b.data[0], b.label[0])
    step.save_checkpoint(d)
    with pytest.raises(tck.CheckpointError, match="no data-iterator state"):
        _port_step(_port_net(4)).restore_checkpoint(d, data_iter=it)
    step.save_checkpoint(d, data_iter=it)
    with pytest.warns(UserWarning, match="replay its epoch"):
        _port_step(_port_net(4)).restore_checkpoint(d)
    it.close()


#: the cross-package continuation's optimizer (see the module docstring)
CROSS_OPT = dict(OPT, learning_rate=1e-3)


def _jax_step(jnet):
    return jmake(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), lint="off",
                 **CROSS_OPT)


def _jax_state(step):
    flat, _ = jax.tree_util.tree_flatten_with_path(step._checkpoint_state())
    return [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in flat]


def _jstep(step, x, y):
    return float(step(nd.array(x, dtype="float32"),
                      nd.array(y, dtype="float32")).asnumpy())


def _tstep(step, x, y):
    return step(torch.from_numpy(x), torch.from_numpy(y)).item()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_train_steps(tmp_path, writer):
    """2 steps on the writer's side, a checkpoint, a restore into the
    other package's fresh step (another seed's weights), then 2 more
    steps on both sides from the same batches.  Both pairs of nets are
    built first: ``mx.random.seed`` (inside ``build_pair``) after the
    JAX step is built makes it draw a new PRNG key."""
    d = str(tmp_path / "ckpt")
    batches = _batches(4)
    jnet, tnet = build_pair(seed=3)
    jnet5, tnet5 = build_pair(seed=5)
    if writer == "jax":
        jstep = _jax_step(jnet)
        for x, y in batches[:2]:
            _jstep(jstep, x, y)
        jstep.save_checkpoint(d)
        tstep_ = tstep.make_train_step(tnet5,
                                       tloss.SoftmaxCrossEntropyLoss(),
                                       device="cpu", **CROSS_OPT)
        assert tstep_.restore_checkpoint(d) == 2
    else:
        tstep_ = tstep.make_train_step(tnet, tloss.SoftmaxCrossEntropyLoss(),
                                       device="cpu", **CROSS_OPT)
        for x, y in batches[:2]:
            _tstep(tstep_, x, y)
        tstep_.save_checkpoint(d)
        jnet = jnet5
        jstep = _jax_step(jnet)
        assert jstep.restore_checkpoint(d) == 2
    want, got = _jax_state(jstep), _state(tstep_)
    assert [k for k, _ in want] == [k for k, _ in got]
    assert "['opt_state'][3][1]" in dict(got)
    for (k, a), (_, b) in zip(want, got):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for x, y in batches[2:]:
        np.testing.assert_allclose(_tstep(tstep_, x, y), _jstep(jstep, x, y),
                                   rtol=0, atol=1e-4)
    params = list(jnet.collect_params().values())
    for p, (name, t) in zip(params, convert.ordered_tensors(tstep_.net)):
        np.testing.assert_allclose(t.detach().numpy(), p.data().asnumpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert tstep_.loss_scale == jstep.loss_scale
    assert tstep_.step_count == jstep.step_count == 4
    assert tstep_.skipped_steps == jstep.skipped_steps == 0
