"""The port's ``gluon.contrib.estimator`` against the JAX package's, on the
CPU: the same net (the reference's weights carried across by position),
data (an ``ArrayDataset`` through a ``DataLoader``, shuffle off) and
handlers on both sides.

- ``fit`` with the default ``Trainer("adam")``: each batch's loss and
  every parameter after 4 batches within 1e-5 of the reference's; the
  train and validation metrics too.
- The handlers as ``tests/test_estimator.py`` drives them:
  ``StoppingHandler`` (``batches`` and ``max_batch``),
  ``ValidationHandler`` (epoch and batch periods), ``CheckpointHandler``
  (the reference's file names, ``max_checkpoints``, ``save_best``, and a
  resume from the reference's own checkpoint directory),
  ``EarlyStoppingHandler``, ``LoggingHandler`` (the same messages) and a
  custom ``BatchProcessor``.
"""
import logging
import os
import re

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.contrib import estimator as jest

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.gluon.contrib import estimator as test_

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)
SIDES = ((jmx, jest, {}), (tmx, test_, {"device": "cpu"}))


def _arrays(n=16, d=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, d)).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def _loader(mx, kw, seed=0, n=16, batch=4):
    x, y = _arrays(n=n, seed=seed)
    return mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(x, y),
                                    batch_size=batch, **kw)


def _nets():
    """The reference's two-layer net and the port's, with its weights."""
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(8, activation="relu", in_units=6),
             jmx.gluon.nn.Dense(3, in_units=8))
    jnet.initialize(jmx.init.Xavier())
    with context.device_scope("cpu"):
        tnet = tmx.gluon.nn.HybridSequential()
        tnet.add(tmx.gluon.nn.Dense(8, activation="relu", in_units=6),
                 tmx.gluon.nn.Dense(3, in_units=8))
    tnet.initialize()
    convert.params_from_jax(tnet, [p.data().asnumpy() for p in
                                   jnet.collect_params().values()])
    return jnet, tnet


def _estimator(mx, est, net, **kw):
    extra = {} if mx is jmx else {"context": CPU}
    return est.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         metrics=kw.pop("metrics", mx.metric.Accuracy()),
                         **kw, **extra)


def _params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _recorder(est):
    class Record(est.BatchEnd, est.EpochEnd):
        def __init__(self):
            self.losses, self.epochs = [], 0

        def batch_end(self, estimator, *args, **kwargs):
            self.losses.append(kwargs["loss"][0].asnumpy().copy())

        def epoch_end(self, estimator, *args, **kwargs):
            self.epochs += 1

    return Record()


def test_fit_matches_reference():
    nets = _nets()
    runs = []
    for (mx, est, kw), net in zip(SIDES, nets):
        e = _estimator(mx, est, net)
        rec = _recorder(est)
        e.fit(_loader(mx, kw), val_data=_loader(mx, kw, seed=1), epochs=1,
              event_handlers=[rec])
        runs.append((rec, e))
    (rj, ej), (rt, et) = runs
    assert len(rt.losses) == len(rj.losses) == 4
    for a, b in zip(rj.losses, rt.losses):
        np.testing.assert_allclose(b, a, **TOL)
    for a, b in zip(_params(nets[0]), _params(nets[1])):
        np.testing.assert_allclose(b, a, **TOL)
    assert et.train_metrics[0].get() == pytest.approx(
        ej.train_metrics[0].get())
    assert et.train_loss_metric.get()[1] == pytest.approx(
        ej.train_loss_metric.get()[1], rel=1e-5)
    assert et.val_metrics[0].get() == pytest.approx(ej.val_metrics[0].get())
    assert et.evaluate(_loader(tmx, SIDES[1][2], seed=2)) == pytest.approx(
        ej.evaluate(_loader(jmx, {}, seed=2)))


@pytest.mark.parametrize("how", ["batches", "max_batch"])
def test_stopping_handler(how):
    counts = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        e = _estimator(mx, est, net)
        rec = _recorder(est)
        if how == "batches":
            e.fit(_loader(mx, kw), batches=3, event_handlers=[rec])
        else:
            e.fit(_loader(mx, kw), epochs=5, event_handlers=[
                rec, est.StoppingHandler(max_epoch=5, max_batch=6)])
        counts.append((len(rec.losses), rec.epochs))
    assert counts[0] == counts[1]


def test_validation_handler_periods():
    out = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        e = _estimator(mx, est, net)
        seen = []

        def evaluate(val_data, _e=e, _seen=seen):
            _seen.append(_e.evaluate(val_data))

        e.fit(_loader(mx, kw), epochs=2, event_handlers=[
            est.ValidationHandler(_loader(mx, kw, seed=1), evaluate,
                                  epoch_period=2, batch_period=3)])
        out.append(seen)
    assert len(out[1]) == len(out[0]) == 3
    for a, b in zip(*out):
        assert b == pytest.approx(a)


def _fit_with_checkpoints(mx, est, kw, net, d, **ckpt_kw):
    e = _estimator(mx, est, net)
    if ckpt_kw.get("save_best"):
        ckpt_kw["monitor"] = e.train_metrics[0]
    ckpt = est.CheckpointHandler(d, model_prefix="toy", **ckpt_kw)
    e.fit(_loader(mx, kw), epochs=3, event_handlers=[ckpt])
    return e, ckpt


@pytest.mark.parametrize("ckpt_kw", [
    dict(epoch_period=1, max_checkpoints=2),
    dict(epoch_period=2),
    dict(save_best=True, mode="max"),
], ids=["period-1-keep-2", "period-2", "save-best"])
def test_checkpoint_handler_files(tmp_path, ckpt_kw):
    files = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        d = str(tmp_path / mx.__name__)
        _fit_with_checkpoints(mx, est, kw, net, d, **ckpt_kw)
        files.append(sorted(os.listdir(d)))
    assert files[0] == files[1] and files[0]


def test_checkpoint_resume_from_reference_directory(tmp_path):
    d = str(tmp_path / "ckpt")
    jnet, _ = _nets()
    _fit_with_checkpoints(jmx, jest, {}, jnet, d, epoch_period=1)
    # the reference resumes its own directory; the port resumes it too
    resumed = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        e = _estimator(mx, est, net)
        ckpt = est.CheckpointHandler(d, model_prefix="toy",
                                     resume_from_checkpoint=True)
        ckpt.train_begin(e)  # the resume: parameters and trainer states
        resumed.append((e.resumed_epoch, ckpt.trained_epoch, _params(net)))
    (ej, tj, pj), (et, tt, pt) = resumed
    assert (et, tt) == (ej, tj) == (3, 2)
    for a, b, c in zip(pj, pt, _params(jnet)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)


def test_port_checkpoint_reloads_bit_for_bit(tmp_path):
    d = str(tmp_path / "ckpt")
    _, tnet = _nets()
    e, _ = _fit_with_checkpoints(tmx, test_, {"device": "cpu"}, tnet, d,
                                 epoch_period=1)
    _, fresh = _nets()
    fresh.load_parameters(os.path.join(d, "toy-epoch2.params"))
    for a, b in zip(_params(tnet), _params(fresh)):
        np.testing.assert_array_equal(b, a)


class _FakeMetric:
    name = "val accuracy"

    def __init__(self, values):
        self.vals = iter(values)

    def get(self):
        return self.name, next(self.vals)

    def reset(self):
        pass

    def update(self, *a):
        pass


@pytest.mark.parametrize("values,patience", [
    ([0.5] * 10, 1), ([0.1, 0.2, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3], 2)])
def test_early_stopping_handler(values, patience):
    out = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        e = _estimator(mx, est, net)
        early = est.EarlyStoppingHandler(monitor=_FakeMetric(values),
                                         patience=patience)
        e.fit(_loader(mx, kw), epochs=len(values), event_handlers=[early])
        out.append((early.current_epoch, early.stopped_epoch, early.best))
    assert out[0] == out[1] and out[0][0] < len(values)


def _log_lines(caplog):
    return [r.getMessage() for r in caplog.records if r.name == "estimator"]


def test_logging_handler_messages(caplog):
    msgs = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="estimator"):
            e = _estimator(mx, est, net)
            e.fit(_loader(mx, kw), epochs=1, event_handlers=[
                est.LoggingHandler(log_interval="batch",
                                   metrics=e.train_metrics
                                   + [e.train_loss_metric])])
        # times differ: compare the text without its numbers, and the
        # metric values apart
        lines = _log_lines(caplog)
        msgs.append(([re.sub(r"[0-9.]+", "#", m) for m in lines],
                     [float(v) for m in lines
                      for v in re.findall(r": ([0-9.]+)", m)]))
    # 4 batches, the epoch and the end of training
    assert msgs[0][0] == msgs[1][0] and len(msgs[0][0]) == 6
    np.testing.assert_allclose(msgs[1][1], msgs[0][1], rtol=0, atol=1e-4)


def test_custom_batch_processor():
    out = []
    for (mx, est, kw), net in zip(SIDES, _nets()):
        calls = {"fit": 0, "eval": 0}

        class Counting(est.BatchProcessor):
            def fit_batch(self, estimator, batch, batch_axis=0):
                calls["fit"] += 1
                return super().fit_batch(estimator, batch, batch_axis)

            def evaluate_batch(self, estimator, batch, batch_axis=0):
                calls["eval"] += 1
                return super().evaluate_batch(estimator, batch, batch_axis)

        e = _estimator(mx, est, net, batch_processor=Counting())
        e.fit(_loader(mx, kw), epochs=2)
        e.val_metrics = [mx.metric.Accuracy()]
        res = e.evaluate(_loader(mx, kw, seed=3))
        out.append((dict(calls), res, _params(net)))
    assert out[0][0] == out[1][0] == {"fit": 8, "eval": 4}
    assert out[1][1] == pytest.approx(out[0][1])
    for a, b in zip(out[0][2], out[1][2]):
        np.testing.assert_allclose(b, a, **TOL)


def test_estimator_initializes_an_uninitialized_net():
    with context.device_scope("cpu"):
        net = tmx.gluon.nn.Dense(3)
    e = test_.Estimator(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        context=CPU)
    e.fit(_loader(tmx, {"device": "cpu"}), batches=2)
    assert np.isfinite(_params(net)[0]).all()
    assert _params(net)[0].shape == (3, 6)
