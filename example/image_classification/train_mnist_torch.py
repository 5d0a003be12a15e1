#!/usr/bin/env python
"""LeNet or an MLP on MNIST through the Module API on one CUDA card
(PyTorch port of ``train_mnist.py``): symbolic composition,
``SoftmaxOutput``, ``mx.mod.Module.fit`` with sgd (momentum 0.9) over
``kv.create(--kv-store)``, ``Speedometer`` and validation.  The same
symbols, flags and defaults as the JAX script, plus ``--device``; it
trains on MNIST idx files where ``--data-dir`` has them (``MNISTIter``),
else on the same synthetic stand-in (2048 images from numpy seed 0, the
last 512 for validation).  ``main(argv)`` returns the per-batch training
losses (the cross-entropy of the softmax outputs at the batch's labels).

On the card (from the repository root):

    python3 example/image_classification/train_mnist_torch.py --network lenet

On the CPU:

    python3 example/image_classification/train_mnist_torch.py --device cpu \\
        --num-epochs 1
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
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import context
from incubator_mxnet_tpu_torch import io as mio
from incubator_mxnet_tpu_torch import symbol as sym


def mlp_symbol(num_classes=10):
    # example/image-classification/symbols/mlp.py
    data = sym.var("data")
    h = sym.FullyConnected(data, sym.var("fc1_weight"), sym.var("fc1_bias"),
                           num_hidden=128)
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, sym.var("fc2_weight"), sym.var("fc2_bias"),
                           num_hidden=64)
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, sym.var("fc3_weight"), sym.var("fc3_bias"),
                           num_hidden=num_classes)
    return sym.SoftmaxOutput(h, sym.var("softmax_label"), name="softmax")


def lenet_symbol(num_classes=10):
    # example/image-classification/symbols/lenet.py
    data = sym.var("data")
    c1 = sym.Convolution(data, sym.var("c1_weight"), sym.var("c1_bias"),
                         kernel=(5, 5), num_filter=20)
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max")
    c2 = sym.Convolution(p1, sym.var("c2_weight"), sym.var("c2_bias"),
                         kernel=(5, 5), num_filter=50)
    a2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(a2, kernel=(2, 2), stride=(2, 2), pool_type="max")
    f = sym.Flatten(p2)
    h = sym.FullyConnected(f, sym.var("fc1_weight"), sym.var("fc1_bias"),
                           num_hidden=500)
    h = sym.Activation(h, act_type="tanh")
    h = sym.FullyConnected(h, sym.var("fc2_weight"), sym.var("fc2_bias"),
                           num_hidden=num_classes)
    return sym.SoftmaxOutput(h, sym.var("softmax_label"), name="softmax")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="mlp", choices=["mlp", "lenet"])
    ap.add_argument("--data-dir", default="data/mnist")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--kv-store", default="local")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def build_symbol(args):
    return mlp_symbol() if args.network == "mlp" else lenet_symbol()


def get_iters(args, device):
    """(train, val) on ``device``: ``MNISTIter`` over the idx files of
    ``--data-dir``, else the synthetic set."""
    flat = args.network == "mlp"
    imgs = os.path.join(args.data_dir, "train-images-idx3-ubyte.gz")
    labs = os.path.join(args.data_dir, "train-labels-idx1-ubyte.gz")
    if os.path.exists(imgs):
        return mio.MNISTIter(image=imgs, label=labs,
                             batch_size=args.batch_size, flat=flat,
                             ctx=device), None
    logging.warning("no MNIST files in %s: synthetic data", args.data_dir)
    rng = np.random.RandomState(0)
    n = 2048
    x = rng.rand(n, 784).astype(np.float32) if flat else \
        rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    split = n - 512
    return (mio.NDArrayIter(x[:split], y[:split], args.batch_size,
                            shuffle=True, ctx=device),
            mio.NDArrayIter(x[split:], y[split:], args.batch_size,
                            ctx=device))


def build_module(args, device):
    """The Module over ``--network``'s symbol on ``device``; its
    ``Uniform(0.01)`` weights draw after ``random.seed(0)``."""
    mx.random.seed(0)
    return mx.mod.Module(build_symbol(args), data_names=["data"],
                         label_names=["softmax_label"], context=device)


def fit(mod, train, val, args, batch_end_callback=()):
    """``Module.fit`` as the JAX script calls it, with
    ``batch_end_callback`` after its ``Speedometer``."""
    mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            kvstore=mx.kv.create(args.kv_store), eval_metric="acc",
            batch_end_callback=[mx.callback.Speedometer(args.batch_size, 50)]
            + list(batch_end_callback))


class BatchLoss:
    """A batch-end callback keeping each batch's mean cross-entropy of
    the module's softmax outputs at the batch's labels."""

    def __init__(self):
        self.losses = []

    def __call__(self, param):
        prob = param.locals["self"].get_outputs()[0].astorch()
        label = param.locals["data_batch"].label[0].astorch().long()
        picked = prob.gather(1, label[:, None]).clamp_min(1e-30)
        self.losses.append(float(-torch.log(picked).mean()))


def main(argv=None):
    """Train ``--num-epochs`` epochs; returns the per-batch losses."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = context.resolve(args.device)
    train, val = get_iters(args, dev)
    mod = build_module(args, dev)
    losses = BatchLoss()
    fit(mod, train, val, args, [losses])
    return losses.losses


if __name__ == "__main__":
    main()
