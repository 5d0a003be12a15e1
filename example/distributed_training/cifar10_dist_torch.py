#!/usr/bin/env python
"""Data-parallel training with ``kv.create('dist_sync_device')`` (PyTorch
port of ``cifar10_dist.py``): every worker trains on its contiguous shard
of a synthetic CIFAR-shaped set, and ``gluon.Trainer`` sums the gradients
across the workers through the dist kvstore (``torch.distributed``), so
the replicas stay bit-identical.  The same flags and defaults as the JAX
script, plus ``--device``; ``main(argv)`` returns the per-batch losses
and the net.  Each rank logs its epochs' mean losses and host time a
step (the loss is read back every step) and, at the end, the SHA-1 of its
trained parameters, which agree across the ranks.

Two ranks on the card (from the repository root; two ranks sharing one
card run gloo, one card per rank NCCL):

    python tools/launch.py -n 2 python \\
        example/distributed_training/cifar10_dist_torch.py

On the CPU:

    python tools/launch.py -n 2 python \\
        example/distributed_training/cifar10_dist_torch.py --device cpu
"""
import argparse
import hashlib
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, context, gluon, kv, nd
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.parallel import distributed


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: cuda:(rank % cards)) or 'cpu'")
    return ap.parse_args(argv)


def build_net(classes=10):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(16, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.MaxPool2D(2),
            nn.Conv2D(32, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(classes))
    return net


def shard(arr, rank, num):
    """SplitSampler semantics: contiguous per-worker shard."""
    per = len(arr) // num
    return arr[rank * per:(rank + 1) * per]


def params_sha1(net):
    """SHA-1 over the bytes of every trained parameter, in
    ``collect_params()`` order: equal digests, equal replicas.  The
    running stats are left out: each worker's BatchNorm keeps its own
    shard's, as the reference's separate processes do."""
    h = hashlib.sha1()
    for p in net.collect_params().values():
        if p.grad_req != "null":
            h.update(p.data().asnumpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    """Train ``--epochs`` epochs on this rank's shard; returns the
    per-batch losses and the net."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    distributed.initialize(device=args.device)
    dev = distributed.local_device(args.device)
    store = kv.create("dist_sync_device")
    rank, nworker = store.rank, store.num_workers

    # synthetic CIFAR-shaped data, sharded per worker
    rng = np.random.RandomState(42)  # same dataset everywhere
    X = rng.rand(args.samples, 3, 32, 32).astype(np.float32)
    Y = rng.randint(0, 10, args.samples).astype(np.float32)
    Xs = shard(X, rank, nworker)
    Ys = shard(Y, rank, nworker)

    mx.random.seed(0)  # identical init on every worker
    with context.device_scope(dev):
        net = build_net()
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1, 3, 32, 32))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05}, kvstore=store)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    bs = args.batch_size
    losses = []
    for epoch in range(args.epochs):
        perm = np.random.RandomState(epoch).permutation(len(Xs))
        total = 0.0
        nb = 0
        t0 = time.perf_counter()
        for lo in range(0, len(Xs) - bs + 1, bs):
            idx = perm[lo:lo + bs]
            x = nd.array(Xs[idx], ctx=dev)
            y = nd.array(Ys[idx], ctx=dev)
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            trainer.step(bs)
            losses.append(float(loss.asscalar()))
            total += losses[-1]
            nb += 1
        logging.info("[rank %d/%d] epoch %d mean loss %.4f  %.2f ms a step",
                     rank, nworker, epoch, total / max(nb, 1),
                     (time.perf_counter() - t0) * 1e3 / max(nb, 1))
    store.barrier()
    logging.info("[rank %d/%d] params sha1 %s", rank, nworker,
                 params_sha1(net))
    return losses, net


if __name__ == "__main__":
    main()
