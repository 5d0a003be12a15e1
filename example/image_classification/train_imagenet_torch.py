#!/usr/bin/env python
"""ImageNet training on one CUDA card (PyTorch port of
``train_imagenet.py``): a model of the vision zoo (default
``resnet50_v1`` with stock BatchNorm), sgd with momentum 0.9 and wd 1e-4
through ``make_train_step``, bf16 compute with f32 parameters, fed by
``ImageRecordIter`` from ``--data-train`` or, without it, by one
synthetic batch resident on the device.  The same flags and defaults as
the JAX script, plus ``--device``.

``--kv-store dist_sync_device`` makes the step data parallel over the
processes that ``tools/launch_torch.py`` starts (a dp mesh, one device each):
``--batch-size`` stays the global batch, each rank steps on its slice of
it (of the one synthetic batch, or read from the RecordIO file with
``part_index=rank``, ``num_parts=world``), and at the end each rank logs
its last loss and the SHA-1 of its parameters and running stats, which
agree across the ranks.

On the card (from the repository root):

    python3 example/image_classification/train_imagenet_torch.py

Over two processes (two ranks sharing one card run gloo; one card each,
NCCL):

    python3 tools/launch_torch.py -n 2 python3 \
        example/image_classification/train_imagenet_torch.py \
        --kv-store dist_sync_device

On the CPU, at a small size:

    python3 example/image_classification/train_imagenet_torch.py \\
        --device cpu --network resnet18_v1 --batch-size 4 \\
        --image-shape 3,32,32 --num-classes 10 --num-batches 10 \\
        --dtype float32
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
import torch

from incubator_mxnet_tpu_torch import (context, convert, gluon, initializer,
                                       random)
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.parallel import (distributed, make_mesh,
                                                make_train_step)
from incubator_mxnet_tpu_torch.parallel.mesh import global_devices


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-train", default="", help=".rec file (synthetic "
                    "batches when empty)")
    ap.add_argument("--data-train-idx", default="")
    ap.add_argument("--network", default="resnet50_v1")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--num-batches", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--kv-store", default="device",
                    choices=["local", "device", "dist_sync_device"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def image_shape(args):
    return tuple(int(s) for s in args.image_shape.split(","))


def build_net(args, device):
    """``args.network`` of the zoo with ``args.num_classes`` classes on
    ``device``: Xavier weights drawn from the device generator after
    ``random.seed(0)``, shapes resolved at the image shape."""
    random.seed(0)
    net = getattr(vision, args.network)(classes=args.num_classes,
                                        device=device)
    initializer.initialize(net, initializer.Xavier(),
                           random.generator(device))
    gluon.shape_init(net, (1,) + image_shape(args))
    return net


def build_mesh(args):
    """The dp mesh over the launched processes for ``--kv-store
    dist_sync_device`` (None otherwise), after the rendezvous."""
    if args.kv_store != "dist_sync_device":
        return None
    distributed.initialize(device=args.device)
    mesh = make_mesh({"dp": -1}, devices=global_devices(args.device))
    logging.info("dp mesh over %d processes (%s)", mesh.size,
                 distributed.backend() or "one process")
    return mesh


def build_step(net, args, device, mesh=None):
    return make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer="sgd", learning_rate=args.lr,
                           momentum=0.9, wd=1e-4, compute_dtype=args.dtype,
                           device=device, mesh=mesh)


def batches(args, device, mesh=None):
    """Endless ``(data, label)`` on ``device``: ``ImageRecordIter`` over
    ``args.data_train`` (reset at each epoch's end), else one synthetic
    batch from numpy seed 0 (the pipeline bypassed).  Over a dp mesh each
    rank gets its slice of the global batch: the iterator reads part
    ``rank`` of ``world`` at the per-rank batch size, and the synthetic
    batch is cut by rank."""
    c, h, w = image_shape(args)
    rank, world = 0, 1
    if mesh is not None:
        rank, world = mesh.axis_index("dp"), mesh.size
        if args.batch_size % world:
            raise ValueError("--batch-size %d (the global batch) does not "
                             "split over %d processes"
                             % (args.batch_size, world))
    if args.data_train:
        from incubator_mxnet_tpu_torch.io import ImageRecordIter

        it = ImageRecordIter(
            path_imgrec=args.data_train,
            path_imgidx=args.data_train_idx or None,
            data_shape=(c, h, w), batch_size=args.batch_size // world,
            shuffle=True, rand_crop=True, rand_mirror=True,
            preprocess_threads=8, prefetch_buffer=8, part_index=rank,
            num_parts=world, ctx=device)
        try:
            while True:
                try:
                    b = next(it)
                except StopIteration:
                    it.reset()
                    b = next(it)
                yield b.data[0], b.label[0]
        finally:
            it.close()
    logging.info("synthetic resident batch (pipeline bypass)")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.rand(args.batch_size, c, h, w).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, args.num_classes, args.batch_size)
                         .astype(np.float32)).to(device)
    if mesh is not None:
        x, y = mesh.local_slice(x), mesh.local_slice(y)
    while True:
        yield x, y


def state_sha1(net):
    """SHA-1 over the bytes of every parameter and running stat, in
    ``collect_params()`` order: equal digests, equal replicas."""
    h = hashlib.sha1()
    for _, t in convert.ordered_tensors(net):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    """Train ``--num-batches`` steps; returns their losses as floats."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    mesh = build_mesh(args)
    dev = context.resolve(args.device) if mesh is None \
        else mesh.local_device
    logging.info("device: %s", torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else "cpu")
    net = build_net(args, dev)
    step = build_step(net, args, dev, mesh)

    losses = []
    src = batches(args, dev, mesh)
    t0 = time.time()
    for i, (bx, by) in enumerate(src):
        loss = step(bx, by)
        losses.append(loss)
        if (i + 1) % 10 == 0:
            value = float(loss)   # waits for the device
            dt = time.time() - t0
            logging.info("batch %d  loss %.3f  %.1f img/s", i + 1, value,
                         10 * args.batch_size / dt)
            t0 = time.time()
        if i + 1 >= args.num_batches:
            break
    src.close()
    if mesh is not None:
        logging.info("[rank %d/%d] last loss %r  state sha1 %s",
                     mesh.axis_index("dp"), mesh.size, float(losses[-1]),
                     state_sha1(net))
    return [float(v) for v in losses]


if __name__ == "__main__":
    main()
