"""Worker body of the port's multi-process tests (``tests/test_torch_dist_*``
and the card test in ``tests/test_torch_cuda.py``).

Each rank runs this script under ``tools/launch.py``, which exports the
``DMLC_*`` rendezvous environment; it imports only the port (never
``jax``).  ``kvstore`` mode holds the dist kvstore to the reference's
checks (``tests/dist_worker.py``) and runs ``cifar10_dist_torch.py``
small and ``train_imagenet_torch.py`` over a RecordIO shard; ``step``
mode runs the data-parallel ``TrainStep`` over the cases the parent
wrote to ``<outdir>/cases.json`` and ``inputs.npz``, then every eager
collective once.  Each rank writes what it saw to
``<outdir>/rank<r>.npz``.

    python tools/launch.py -n 2 python tests/torch_dist_worker.py \\
        MODE OUTDIR [cpu|cuda]
"""
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import (_kernels, autograd, context, convert,
                                       gluon, kv)
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
    BasicBlockV1
from incubator_mxnet_tpu_torch.parallel import (collectives, distributed,
                                                make_mesh, make_train_step)
from incubator_mxnet_tpu_torch.parallel.mesh import global_devices


def _example(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "example", *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cifar_example():
    return _example("cifar10_dist_torch", "distributed_training",
                    "cifar10_dist_torch.py")


def build_net(kind, image, dev):
    """The port's side of a parent-built net: ``mlp`` (a ragged
    ``Dense(13)`` head), ``convbn`` (the cifar10 example's conv-BN net)
    or ``block`` (``BasicBlockV1(ghost_bn=4)`` with a GhostBN
    downsample)."""
    mx.random.seed(0)
    with context.device_scope(dev):
        if kind == "mlp":
            net = nn.HybridSequential()
            net.add(nn.Dense(16, in_units=10, activation="relu"),
                    nn.Dense(13, in_units=16))
        elif kind == "convbn":
            net = _cifar_example().build_net()
        else:
            net = nn.HybridSequential()
            net.add(BasicBlockV1(128, 1, downsample=True, in_channels=3,
                                 ghost_bn=4),
                    nn.GlobalAvgPool2D(), nn.Dense(10, in_units=128))
    net.initialize(init=mx.init.Xavier())
    if kind != "mlp":
        net.shape_init((1, 3, image, image))
    return net


def run_steps(case, inputs, dev, mesh):
    """``case["steps"]`` steps of the dp step on this rank's slices of the
    parent's global batches, from the parent's weights."""
    name = case["name"]
    net = build_net(case["net"], case.get("image", 0), dev)
    n_w = len(convert.ordered_tensors(net))
    convert.params_from_jax(net, [inputs["%s.w%d" % (name, i)]
                                  for i in range(n_w)])
    step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           device=dev, mesh=mesh, zero=case["zero"],
                           **case["opt"])
    losses = []
    collectives.reset_call_counts()
    _kernels.reset_launch_counts()
    for s in range(case["steps"]):
        x = torch.from_numpy(inputs["%s.x%d" % (name, s)])
        y = torch.from_numpy(inputs["%s.y%d" % (name, s)])
        loss = step(mesh.local_slice(x).to(dev), mesh.local_slice(y).to(dev))
        losses.append(float(loss))
    out = {"%s.loss" % name: np.asarray(losses, np.float64),
           "%s.scale" % name: np.float64(step.loss_scale),
           "%s.collectives" % name: np.asarray(json.dumps(
               collectives.call_counts())),
           "%s.kernels" % name: np.asarray(json.dumps(
               _kernels.launch_counts()))}
    for i, a in enumerate(convert.params_to_numpy(net)):
        out["%s.p%d" % (name, i)] = a
    return out


def collective_checks(dev, mesh):
    """Every eager collective of ``parallel/collectives.py`` once over the
    dp axis, on rank-dependent values on ``dev`` (the backend moves CUDA
    tensors too)."""
    n = mesh.size
    x = _collective_input(mesh.axis_index("dp"), n, dev)
    got = {"allreduce": collectives.allreduce(x, mesh=mesh),
           "pmean": collectives.pmean(x, mesh=mesh),
           "allgather": collectives.allgather(x, mesh=mesh),
           "reduce_scatter": collectives.reduce_scatter(x, mesh=mesh),
           "alltoall": collectives.alltoall(x, mesh=mesh),
           "ppermute": collectives.ppermute(
               x, perm=[(i, (i + 1) % n) for i in range(n)], mesh=mesh),
           "broadcast_from": collectives.broadcast_from(x, src=n - 1,
                                                        mesh=mesh)}
    return {"coll.%s" % k: v.cpu().numpy() for k, v in got.items()}


def _collective_input(rank, n, dev=None):
    x = np.arange(4 * n, dtype=np.float32).reshape(2 * n, 2) + 100 * rank
    return x if dev is None else torch.from_numpy(x).to(dev)


def collectives_expected(rank, n):
    """What :func:`collective_checks` must return on ``rank`` of ``n``."""
    xs = [_collective_input(r, n) for r in range(n)]
    total = sum(xs)
    return {"coll.allreduce": total, "coll.pmean": total / n,
            "coll.allgather": np.concatenate(xs),
            "coll.reduce_scatter": total[2 * rank:2 * rank + 2],
            "coll.alltoall": np.concatenate([x[2 * rank:2 * rank + 2]
                                             for x in xs]),
            "coll.ppermute": xs[(rank - 1) % n],
            "coll.broadcast_from": xs[n - 1]}


def kvstore_checks(dev):
    """The reference's dist kvstore checks, the Trainer over the store
    and a small run of ``cifar10_dist_torch.py``."""
    store = kv.create("dist_sync")
    rank, nw = store.rank, store.num_workers
    assert nw == int(os.environ["DMLC_NUM_WORKER"]), (nw, os.environ)

    def full(shape, v):
        return mx.nd.full(shape, v, ctx=dev)

    def zeros(shape):
        return mx.nd.zeros(shape, ctx=dev)

    out = {"rank": np.int32(rank), "nw": np.int32(nw)}
    # init: rank 0's value wins everywhere
    store.init("w", full((4, 3), rank + 7.0))
    got = zeros((4, 3))
    store.pull("w", out=got)
    out["init"] = got.asnumpy()
    # push: the exact sum across the workers
    store.push("w", full((4, 3), float(rank + 1)))
    got = zeros((4, 3))
    store.pull("w", out=got)
    out["sum"] = got.asnumpy()
    # update_on_kvstore: identical sgd updates everywhere
    opt_store = kv.create("dist_sync")
    opt_store.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    opt_store.init(3, mx.nd.ones((5, 2), ctx=dev))
    opt_store.push(3, full((5, 2), float(rank + 1)))
    got = zeros((5, 2))
    opt_store.pull(3, out=got)
    out["opt"] = got.asnumpy()
    # a multi-key push: exact sums in one all_reduce
    store.init(["mk1", "mk2"], [zeros((3, 2)), zeros((5,))])
    collectives.reset_call_counts()
    store.push(["mk1", "mk2"], [full((3, 2), float(rank + 1)),
                                full((5,), 10.0 * (rank + 1))])
    out["mk_counts"] = np.asarray(json.dumps(collectives.call_counts()))
    mk1, mk2 = zeros((3, 2)), zeros((5,))
    store.pull(["mk1", "mk2"], out=[mk1, mk2])
    out["mk1"], out["mk2"] = mk1.asnumpy(), mk2.asnumpy()

    # gluon.Trainer over the dist store, from the parent's weights
    inputs = np.load(os.path.join(sys.argv[2], "inputs.npz"))
    with context.device_scope(dev):
        net = nn.Dense(2, in_units=3)
    net.initialize()
    convert.params_from_jax(net, [inputs["trainer.w0"], inputs["trainer.w1"]])
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05},
                            kvstore=kv.create("dist_sync"))
    loss_fn = gluon.loss.L2Loss()
    for s in range(3):
        x = mx.nd.array(inputs["trainer.x%d_%d" % (s, rank)], ctx=dev)
        y = mx.nd.array(inputs["trainer.y%d_%d" % (s, rank)], ctx=dev)
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(4)
    out["trained_w"] = net.weight.detach().cpu().numpy()
    out["trained_b"] = net.bias.detach().cpu().numpy()

    # the example, small
    ex = _cifar_example()
    losses, cnet = ex.main(["--device", dev.type, "--samples", "64",
                            "--batch-size", "8", "--epochs", "2"])
    out["cifar_losses"] = np.asarray(losses, np.float64)
    for i, p in enumerate(cnet.collect_params().values()):
        if p.grad_req != "null":
            out["cifar_p%d" % i] = p.data().asnumpy()
    out.update(trainer_recordio(dev))
    store.barrier()
    return out


def trainer_recordio(dev):
    """``train_imagenet_torch.py --kv-store dist_sync_device`` over the
    parent's RecordIO shard (``<outdir>/shard.rec``, record i labelled
    i), with a thumbnail ResNet: the labels this rank reads in one epoch
    of its part, then the trainer's losses over 3 batches."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    vision.tiny_resnet = lambda classes, device: resnet.ResNetV1(
        BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=classes,
        thumbnail=True, device=device)
    ex = _example("train_imagenet_torch", "image_classification",
                  "train_imagenet_torch.py")
    prefix = os.path.join(sys.argv[2], "shard")
    argv = ["--device", dev.type, "--network", "tiny_resnet",
            "--batch-size", "4", "--image-shape", "3,32,32",
            "--num-classes", "8", "--dtype", "float32",
            "--kv-store", "dist_sync_device", "--data-train",
            prefix + ".rec", "--data-train-idx", prefix + ".idx",
            "--num-batches", "3"]
    args = ex.parse_args(argv)
    src = ex.batches(args, dev, ex.build_mesh(args))
    labels = [next(src)[1].asnumpy() for _ in range(2)]
    src.close()
    return {"rec_labels": np.concatenate(labels),
            "rec_losses": np.asarray(ex.main(argv), np.float64)}


def main():
    mode, outdir = sys.argv[1], sys.argv[2]
    platform = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    distributed.initialize(device=platform)
    dev = distributed.local_device(platform)
    if mode == "kvstore":
        out = kvstore_checks(dev)
    else:
        with open(os.path.join(outdir, "cases.json")) as f:
            cases = json.load(f)
        inputs = np.load(os.path.join(outdir, "inputs.npz"))
        mesh = make_mesh({"dp": -1}, devices=global_devices(platform))
        out = {"rank": np.int32(distributed.process_index()),
               "backend": np.asarray(distributed.backend())}
        for case in cases:
            out.update(run_steps(case, inputs, dev, mesh))
        out.update(collective_checks(dev, mesh))
    distributed.barrier("done")
    np.savez(os.path.join(outdir, "rank%d.npz" % distributed.process_index()),
             **out)
    print("worker %d ok" % distributed.process_index(), flush=True)


if __name__ == "__main__":
    main()
