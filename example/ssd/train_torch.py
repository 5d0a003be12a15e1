#!/usr/bin/env python
"""SSD detection training on one CUDA card (PyTorch port of ``train.py``,
graded config 5; reference: example/ssd/train.py -> train/train_net.py:
239-264).

A compact SSD over a tiny conv backbone on synthetic detection data:
``MultiBoxPrior`` anchors over the feature map, ``MultiBoxTarget``
matching, a joint softmax cross-entropy and L1 location loss through
``autograd.record()`` and ``gluon.Trainer("sgd")``, then a decode with
NMS by ``MultiBoxDetection``.  The same model, data, flags and defaults
as the JAX script, plus ``--device``.  ``main(argv)`` returns the
per-batch losses and the last decode.

On the card (from the repository root):

    python3 example/ssd/train_torch.py

On the CPU:

    python3 example/ssd/train_torch.py --device cpu
"""
import argparse
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, context, gluon, nd
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.ops import registry as reg

#: the anchors a feature-map pixel: len(SIZES) + len(RATIOS) - 1
SIZES, RATIOS = (0.3, 0.5), (1.0, 2.0)
NUM_CLASSES = 3
IMAGE = 32


class TinySSD(gluon.HybridBlock):
    """One-scale SSD head (symbol_builder.py:90's shape, miniaturized)."""

    def __init__(self, num_classes=NUM_CLASSES, num_anchors=3, **kw):
        super().__init__(**kw)
        self._nc = num_classes
        self._na = num_anchors
        with self.name_scope():
            self.features = nn.HybridSequential()
            self.features.add(nn.Conv2D(16, 3, padding=1, strides=2),
                              nn.Activation("relu"),
                              nn.Conv2D(32, 3, padding=1, strides=2),
                              nn.Activation("relu"))
            self.cls_head = nn.Conv2D(num_anchors * (num_classes + 1), 3,
                                      padding=1)
            self.loc_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

    def hybrid_forward(self, F, x):  # noqa: N803
        feat = self.features(x)
        return feat, self.cls_head(feat), self.loc_head(feat)


def synthetic_batch(rng, batch, size=IMAGE):
    """Images with one colored square; label = (cls, x1, y1, x2, y2)."""
    imgs = rng.rand(batch, 3, size, size).astype(np.float32) * 0.1
    labels = np.full((batch, 1, 5), -1.0, np.float32)
    for i in range(batch):
        cls = rng.randint(0, 3)
        w = rng.randint(8, 16)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - w)
        imgs[i, cls, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return imgs, labels


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def build_net(args, device):
    """``(net, trainer, cls_loss)`` on ``device``: the net
    Xavier-initialized after ``random.seed(0)``, its widths resolved at
    ``IMAGE`` px."""
    mx.random.seed(0)
    with context.device_scope(device):
        net = TinySSD()
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1, 3, IMAGE, IMAGE))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr})
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss()


def heads(net, x):
    """``(anchors (1, A, 4), class predictions (N, C+1, A), location
    predictions (N, A*4))`` of the images ``x``."""
    batch = x.shape[0]
    feat, cls_pred, loc_pred = net(x)
    anchors = reg.invoke("_contrib_MultiBoxPrior", [feat], sizes=SIZES,
                         ratios=RATIOS)
    n_anchor = anchors.shape[1]
    cp = cls_pred.transpose((0, 2, 3, 1)).reshape(
        (batch, n_anchor, NUM_CLASSES + 1)).transpose((0, 2, 1))
    lp = loc_pred.transpose((0, 2, 3, 1)).reshape((batch, -1))
    return anchors, cp, lp


def train_step(net, trainer, cls_loss, x, y):
    """One step on images ``x`` and labels ``y`` (NDArrays); returns the
    loss as an NDArray (not read back)."""
    batch = x.shape[0]
    with autograd.record():
        anchors, cp, lp = heads(net, x)
        with autograd.pause():
            loc_t, loc_mask, cls_t = reg.invoke(
                "_contrib_MultiBoxTarget", [anchors, y, cp])
        cls_l = cls_loss(cp.transpose((0, 2, 1)).reshape(
            (-1, NUM_CLASSES + 1)), cls_t.reshape((-1,)))
        loc_l = ((lp - loc_t).abs() * loc_mask).mean()
        loss = cls_l.mean() + loc_l
    loss.backward()
    trainer.step(batch)
    return loss


def train_steps(net, trainer, cls_loss, rng, args, device, log=False):
    """``args.batches`` steps on fresh synthetic batches drawn from
    ``rng``; returns the losses as NDArrays."""
    losses = []
    for b in range(args.batches):
        imgs, labels = synthetic_batch(rng, args.batch_size)
        losses.append(train_step(net, trainer, cls_loss,
                                 nd.array(imgs, ctx=device),
                                 nd.array(labels, ctx=device)))
        if log and ((b + 1) % 20 == 0 or (b + 1) == args.batches):
            logging.info("batch %d  loss %.4f", b + 1,
                         float(losses[-1].asscalar()))
    return losses


def decode(net, imgs, device):
    """Detections of the images ``imgs`` (numpy): softmax over the
    classes, then ``MultiBoxDetection`` with NMS at 0.5 -> (N, A, 6) rows
    [cls_id, score, xmin, ymin, xmax, ymax], suppressed rows -1."""
    anchors, cp, lp = heads(net, nd.array(imgs, ctx=device))
    cls_prob = reg.invoke("softmax", [cp], axis=1)
    return reg.invoke("_contrib_MultiBoxDetection", [cls_prob, lp, anchors],
                      nms_threshold=0.5)


def main(argv=None):
    """Train, then decode one batch; returns (losses, detections) as
    numpy."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = context.resolve(args.device)
    rng = np.random.RandomState(0)
    net, trainer, cls_loss = build_net(args, dev)
    losses = train_steps(net, trainer, cls_loss, rng, args, dev, log=True)
    imgs, _ = synthetic_batch(rng, args.batch_size)
    dets = decode(net, imgs, dev)
    logging.info("detections shape: %s (id/score/4 coords per anchor)",
                 dets.shape)
    return np.array([float(v.asscalar()) for v in losses]), dets.asnumpy()


if __name__ == "__main__":
    main()
