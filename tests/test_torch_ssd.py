"""``example/ssd/train_torch.py`` against the JAX example
(``example/ssd/train.py``), f32 on the CPU.

The JAX example's ``TinySSD`` and loop (``MultiBoxPrior``,
``MultiBoxTarget`` under ``autograd.pause()``, ``SoftmaxCrossEntropyLoss``
plus the masked L1 location loss, ``Trainer("sgd")``, ``step(batch)``)
and the port's, at batch 4, lr 0.05 on the example's synthetic batches,
the port's weights copied from the reference's by position: the losses
of the first 5 steps within 1e-5 (relative), every parameter after them
within 1e-5 of its largest magnitude, and the decode of one more batch
(softmax, ``MultiBoxDetection`` with NMS at 0.5): the same rows kept with
the same class ids, scores and boxes within 1e-5.  ``main`` trains on the
CPU when asked.
"""
import importlib.util
import os

import numpy as np

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--batch-size", "4", "--batches", "5",
         "--lr", "0.05"]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_heads(net, x, batch):
    feat, cls_pred, loc_pred = net(x)
    anchors = jreg.invoke("_contrib_MultiBoxPrior", [feat],
                          sizes=(0.3, 0.5), ratios=(1.0, 2.0))
    n_anchor = anchors.shape[1]
    cp = cls_pred.transpose((0, 2, 3, 1)).reshape(
        (batch, n_anchor, 4)).transpose((0, 2, 1))
    lp = loc_pred.transpose((0, 2, 3, 1)).reshape((batch, -1))
    return anchors, cp, lp


def test_steps_and_decode_match_reference():
    jex = _load("_ssd_jax", "example/ssd/train.py")
    tex = _load("_ssd_torch", "example/ssd/train_torch.py")
    args = tex.parse_args(SMALL)
    batch = args.batch_size

    jmx.random.seed(0)
    jnet = jex.TinySSD()
    jnet.initialize(init=jmx.init.Xavier())
    jnet.shape_init((1, 3, 32, 32))
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                 {"learning_rate": args.lr})
    jloss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()

    dev = tmx.cpu()
    tnet, ttrainer, tloss_fn = tex.build_net(args, dev)
    convert.params_from_jax(tnet, [p.data().asnumpy() for p in
                                   jnet.collect_params().values()])

    jrng = np.random.RandomState(0)
    jl = []
    for _ in range(args.batches):
        imgs, labels = jex.synthetic_batch(jrng, batch)
        with jmx.autograd.record():
            anchors, cp, lp = _jax_heads(jnet, jmx.nd.array(imgs), batch)
            with jmx.autograd.pause():
                loc_t, loc_mask, cls_t = jreg.invoke(
                    "_contrib_MultiBoxTarget",
                    [anchors, jmx.nd.array(labels), cp])
            cls_l = jloss_fn(cp.transpose((0, 2, 1)).reshape((-1, 4)),
                             cls_t.reshape((-1,)))
            loss = cls_l.mean() + ((lp - loc_t).abs() * loc_mask).mean()
        loss.backward()
        jtrainer.step(batch)
        jl.append(float(loss.asscalar()))

    trng = np.random.RandomState(0)
    tl = [float(v.asscalar()) for v in tex.train_steps(
        tnet, ttrainer, tloss_fn, trng, args, dev)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)

    for (name, t), j in zip(convert.ordered_tensors(tnet),
                            jnet.collect_params().values()):
        want = j.data().asnumpy()
        err = np.abs(t.detach().numpy() - want).max()
        assert err <= 1e-5 * max(np.abs(want).max(), 1e-30), (name, err)

    imgs, _ = jex.synthetic_batch(jrng, batch)
    timgs, _ = tex.synthetic_batch(trng, batch)
    assert np.array_equal(imgs, timgs)
    anchors, cp, lp = _jax_heads(jnet, jmx.nd.array(imgs), batch)
    cls_prob = jreg.invoke("softmax", [cp], axis=1)
    jd = jreg.invoke("_contrib_MultiBoxDetection", [cls_prob, lp, anchors],
                     nms_threshold=0.5).asnumpy()
    td = tex.decode(tnet, imgs, dev).asnumpy()
    assert td.shape == jd.shape == (batch, 192, 6)
    assert np.array_equal(td[..., 0], jd[..., 0])
    assert (td[..., 0] >= 0).sum() > 0
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)


def test_main_trains_on_cpu():
    tex = _load("_ssd_torch_main", "example/ssd/train_torch.py")
    losses, dets = tex.main(["--device", "cpu", "--batch-size", "4",
                             "--batches", "40"])
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-20:].mean() < losses[:20].mean()
    assert dets.shape == (4, 192, 6)
