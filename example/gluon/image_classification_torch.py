#!/usr/bin/env python
"""Gluon training loop on one CUDA card (PyTorch port of
``image_classification.py``): a model of the vision zoo, ``hybridize``,
``autograd.record``, ``gluon.Trainer`` (sgd, momentum 0.9) over
``kv.create("device")`` and ``metric.Accuracy``, on synthetic data from
numpy seed 0.  The same flags and defaults as the JAX script, plus
``--device`` and ``--amp bfloat16|float16`` (``contrib.amp``: the cast
policy, a loss scaler on the trainer, the loss scaled before backward);
``main(argv)`` returns the per-batch losses.

On the card (from the repository root):

    python3 example/gluon/image_classification_torch.py

On the CPU:

    python3 example/gluon/image_classification_torch.py --device cpu \\
        --epochs 1 --samples 32
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
from incubator_mxnet_tpu_torch import autograd, context, gluon
from incubator_mxnet_tpu_torch.contrib import amp
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.io import NDArrayIter


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18_v1")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--no-hybridize", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--amp", default=None, choices=("bfloat16", "float16"),
                    help="mixed precision: amp.init(AMP) before the net is "
                         "built")
    return ap.parse_args(argv)


def build_net(args, device):
    """``args.model`` of the zoo on ``device``: Xavier weights after
    ``random.seed(0)``, shapes resolved at the image size, hybridized
    unless ``--no-hybridize``."""
    mx.random.seed(0)
    net = getattr(vision, args.model)(classes=args.num_classes,
                                      device=device)
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1, 3, args.image_size, args.image_size))
    if not args.no_hybridize:
        net.hybridize()
    return net


def build_data(args, device):
    """The synthetic set from numpy seed 0, shuffled each epoch."""
    rng = np.random.RandomState(0)
    X = rng.rand(args.samples, 3, args.image_size,
                 args.image_size).astype(np.float32)
    Y = rng.randint(0, args.num_classes, args.samples).astype(np.float32)
    return NDArrayIter(X, Y, args.batch_size, shuffle=True, ctx=device)


def build_trainer(net, args):
    """sgd with momentum 0.9 over ``kv.create("device")``; with ``--amp``
    the shared loss scaler attached (``amp.init_trainer``)."""
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr, "momentum": 0.9},
                            kvstore=mx.kv.create("device"))
    if getattr(args, "amp", None):
        amp.init_trainer(trainer)
    return trainer


def train_batch(net, trainer, loss_fn, metric, x, y, batch_size):
    """One step of the loop: forward and loss under ``record``,
    backward (of the loss scaled by ``amp.scale_loss`` where the trainer
    has a loss scaler), ``trainer.step``, the metric.  Returns the loss
    NDArray."""
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y).mean()
        scaled = loss
        if getattr(trainer, "_amp_loss_scaler", None) is not None:
            with amp.scale_loss(loss, trainer) as scaled:
                pass
    scaled.backward()
    trainer.step(batch_size)
    metric.update([y], [out])
    return loss


def main(argv=None):
    """Train ``--epochs`` epochs; returns the per-batch losses."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = context.resolve(args.device)
    if args.amp:
        amp.init(args.amp)
    net = build_net(args, dev)
    it = build_data(args, dev)
    trainer = build_trainer(net, args)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()

    losses = []
    for epoch in range(args.epochs):
        it.reset()
        metric.reset()
        total, nb = 0.0, 0
        for batch in it:
            x, y = batch.data[0], batch.label[0]
            loss = train_batch(net, trainer, loss_fn, metric, x, y,
                               args.batch_size)
            losses.append(float(loss.asscalar()))
            total += losses[-1]
            nb += 1
        logging.info("epoch %d  loss %.4f  %s", epoch, total / nb,
                     metric.get())
    return losses


if __name__ == "__main__":
    main()
