"""Worker body of the port's multi-process tests (``tests/test_torch_dist_*``
and the card test in ``tests/test_torch_cuda.py``).

Each rank runs this script under ``tools/launch_torch.py``, which exports the
``DMLC_*`` rendezvous environment; it imports only the port (never
``jax``).  ``kvstore`` mode holds the dist kvstore to the reference's
checks (``tests/dist_worker.py``) and runs ``cifar10_dist_torch.py``
small and ``train_imagenet_torch.py`` over a RecordIO shard; ``step``
mode runs the data-parallel ``TrainStep`` over the cases the parent
wrote to ``<outdir>/cases.json`` and ``inputs.npz``, then every eager
collective once.  The elastic modes (``tests/test_torch_elastic.py``,
the card test) train the reference's elastic net (two ``Dense(16,
tanh)`` and a ragged ``Dense(13)``, adam, ZeRO-1, a dynamic loss scale)
over a shuffled ``ResilientIter(NDArrayIter)`` of the global batches,
each rank on its rows:

- ``elastic_save``: 6 steps from the parent's weights with a
  checkpoint of step 3 (``ckpt_dp2``), then the restores of the JAX
  package's checkpoints that the parent writes meanwhile and lists in
  ``jax_ready`` (``jax_dp2``, ``jax_dp8``; none on the card);
- ``elastic_restore``: the parent's dp=1 re-save (``ckpt_dp1``) and its
  ``zero=0`` checkpoint (``ckpt_zero0``) restored at dp=2 and stepped,
  the latter saved at steps 3 and 4 (``ckpt_walk``); rank 1 corrupts its
  own shard of step 4 and both ranks must restore step 3; then the
  kill: 4 steps with a checkpoint of step 2 (``kill_ckpt``) and, in the
  step-4 save, rank 1 killed by ``fault_injection.host_loss_during_save``;
  rank 0 must refuse the commit (the job then fails, as it should).

Each rank writes what it saw to ``<outdir>/rank<r>.npz`` (the elastic
modes before the kill; the kill's observations go to
``<outdir>/kill_rank<r>.json``).  ``async`` mode runs ``dist_async``
with unequal step counts (the reference's ``tests/async_worker.py``).

    python tools/launch_torch.py -n 2 python tests/torch_dist_worker.py \\
        MODE OUTDIR [cpu|cuda]
"""
import importlib.util
import json
import os
import sys
import time
import warnings

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
from incubator_mxnet_tpu_torch.io import NDArrayIter, ResilientIter
from incubator_mxnet_tpu_torch.parallel import (CheckpointError,
                                                CheckpointManager,
                                                collectives, distributed,
                                                make_mesh, make_train_step)
from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
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


# -- the elastic modes ---------------------------------------------------------

ELASTIC_FEAT = 16
ELASTIC_BATCH = 8  # global


def elastic_data():
    """The reference worker's data: 64 rows of 16 features, 4 classes."""
    rng = np.random.RandomState(5)
    return (rng.rand(64, ELASTIC_FEAT).astype(np.float32),
            rng.randint(0, 4, 64).astype(np.float32))


def elastic_net(dev, weights=None, seed=0, head=13):
    """Two ``Dense(16, tanh)`` and a ``Dense(head)`` (13 rows pad to 14
    at dp=2, 16 at dp=8), with ``weights`` (numpy, ``collect_params()``
    order) or drawn from ``seed``."""
    mx.random.seed(seed)
    with context.device_scope(dev):
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=ELASTIC_FEAT, activation="tanh"),
                nn.Dense(16, in_units=16, activation="tanh"),
                nn.Dense(head, in_units=16))
    net.initialize(init=mx.init.Xavier())
    if weights is not None:
        convert.params_from_jax(net, weights)
    return net


def elastic_step(net, dev, mesh, zero=1):
    return make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer="adam", learning_rate=1e-3,
                           loss_scale="dynamic", device=dev, mesh=mesh,
                           zero=zero)


def elastic_iter(shuffle_seed, batch_size=ELASTIC_BATCH):
    X, Y = elastic_data()
    np.random.seed(shuffle_seed)
    return ResilientIter(NDArrayIter(X, Y, batch_size=batch_size,
                                     shuffle=True, ctx=mx.cpu()))


def elastic_feed(step, mesh, batch, dev):
    """One step on this rank's rows of the global batch; the loss."""
    x, y = (mesh.local_slice(v._data).to(dev)
            for v in (batch.data[0], batch.label[0]))
    return float(step(x, y))


def logical_parts(step, prefix):
    """What a re-shard must keep, as this rank holds it: params, aux,
    PRNG key, step counter, loss-scale state, and this rank's rows of
    each optimizer-state leaf without the ZeRO padding."""
    def host(t):  # a copy: the step updates its tensors in place
        return t.detach().cpu().numpy().copy()

    out = {prefix + "step": np.int64(step.step_count),
           prefix + "rng": np.array(step._rng_key)}
    for i, t in enumerate(step._gp):
        out["%sp%d" % (prefix, i)] = host(t)
    for i, t in enumerate(step._aux):
        out["%sa%d" % (prefix, i)] = host(t)
    for i, t in enumerate((step._scale, step._unskipped, step._skipped)):
        out["%ss%d" % (prefix, i)] = host(t)
    pads = step._zero_pad0 or [None] * len(step._gp)
    k = 0
    for s, p, pad0 in zip(step._opt_state, step._gp, pads):
        for leaf in (s if isinstance(s, tuple) else (s,)):
            a = host(leaf)
            if pad0 is not None and step._n > 1:
                lo = step._rank * (pad0 // step._n)
                a = a[:max(0, min(len(a), p.shape[0] - lo))]
            out["%so%d" % (prefix, k)] = a
            k += 1
    return out


def _elastic_manager(outdir, name, **kw):
    return CheckpointManager(os.path.join(outdir, name), **kw)


def elastic_save(dev, mesh, outdir):
    """The uninterrupted dp=2 run with a checkpoint of step 3, then the
    JAX package's checkpoints restored here."""
    inputs = np.load(os.path.join(outdir, "inputs.npz"))
    weights = [inputs["el.w%d" % i] for i in range(6)]
    step = elastic_step(elastic_net(dev, weights), dev, mesh)
    it = elastic_iter(3)
    out, idx, losses = {}, [], []
    for k in range(6):
        b = it.next()
        idx.append(np.asarray(b.index).copy())
        losses.append(elastic_feed(step, mesh, b, dev))
        if k == 2:
            t0 = time.perf_counter()
            step.save_checkpoint(_elastic_manager(outdir, "ckpt_dp2",
                                                  commit_timeout=60),
                                 data_iter=it)
            out["save_s"] = np.float64(time.perf_counter() - t0)
            out.update(logical_parts(step, "a3."))
    it.close()
    out["a.idx"], out["a.loss"] = np.stack(idx), np.asarray(losses)
    # the parent lists the JAX checkpoints it wrote (none on the card's
    # host, which has no JAX) in jax_ready, written last
    ready = os.path.join(outdir, "jax_ready")
    deadline = time.monotonic() + 180
    while not os.path.exists(ready):
        if time.monotonic() > deadline:
            raise AssertionError("the parent wrote no jax_ready")
        time.sleep(0.1)
    with open(ready) as f:
        names = f.read().split()
    for name in names:
        other = elastic_step(elastic_net(dev, seed=17), dev, mesh)
        out[name + ".restored"] = np.int64(
            other.restore_checkpoint(os.path.join(outdir, name)))
        out.update(logical_parts(other, name + "."))
    return out


def elastic_restore(dev, mesh, outdir):
    """The parent's dp=1 re-save back at dp=2 (then 3 steps), and its
    ``zero=0`` checkpoint at ``zero=1`` (then one step)."""
    out = {}
    step = elastic_step(elastic_net(dev, seed=23), dev, mesh)
    it = elastic_iter(13)
    out["b.restored"] = np.int64(step.restore_checkpoint(
        os.path.join(outdir, "ckpt_dp1"), data_iter=it))
    out.update(logical_parts(step, "b3."))
    idx, losses = [], []
    for _ in range(3):
        b = it.next()
        idx.append(np.asarray(b.index).copy())
        losses.append(elastic_feed(step, mesh, b, dev))
    it.close()
    out["b.idx"], out["b.loss"] = np.stack(idx), np.asarray(losses)
    step = elastic_step(elastic_net(dev, seed=29), dev, mesh)
    it = elastic_iter(13)
    out["z.restored"] = np.int64(step.restore_checkpoint(
        os.path.join(outdir, "ckpt_zero0"), data_iter=it))
    out.update(logical_parts(step, "z."))
    walk = _elastic_manager(outdir, "ckpt_walk", commit_timeout=60)
    step.save_checkpoint(walk, data_iter=it)
    out["z.loss"] = np.float64(elastic_feed(step, mesh, it.next(), dev))
    step.save_checkpoint(walk, data_iter=it)
    it.close()
    out.update(walk_back(dev, mesh, walk))
    return out


def walk_back(dev, mesh, mgr):
    """Rank 1 flips a bit of its own shard file of ``mgr``'s newest step
    (4); both ranks must then restore step 3, and both refuse step 4
    asked for by name.  Each rank reads only the files of its rows, so
    rank 1 alone sees the damage."""
    if distributed.process_index() == 1:
        d = os.path.join(mgr.directory, "step-00000004")
        names = sorted(n for n in os.listdir(d) if n.endswith(".bin"))
        fi.corrupt_checkpoint(mgr.directory, step=4, which=[
            ".shard001." in n for n in names].index(True))
    distributed.barrier("corrupted")
    step = elastic_step(elastic_net(dev, seed=31), dev, mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored = step.restore_checkpoint(mgr)
    out = {"w.restored": np.int64(restored),
           "w.warned": np.bool_(any("is corrupt" in str(w.message)
                                    for w in caught))}
    out.update(logical_parts(step, "w."))
    try:  # step 4 asked for by name: every rank refuses it
        step.restore_checkpoint(mgr, step=4)
        out["w.pinned"] = np.asarray("restored")
    except CheckpointError as e:
        out["w.pinned"] = np.asarray(type(e).__name__)
    return out


def elastic_kill(dev, mesh, outdir):
    """4 steps with a committed checkpoint of step 2; in the step-4 save
    rank 1 dies mid-stage, and rank 0 must refuse the commit.  Exits the
    process: 3 on rank 0's expected refusal, else 4 or 5."""
    rank = distributed.process_index()
    inputs = np.load(os.path.join(outdir, "inputs.npz"))
    step = elastic_step(elastic_net(dev, [inputs["el.w%d" % i]
                                          for i in range(6)]), dev, mesh)
    mgr = _elastic_manager(outdir, "kill_ckpt", commit_timeout=5.0)
    it = elastic_iter(3)
    obs = {"losses": [], "idx": []}

    def dump(**kw):
        obs.update(kw, steps=mgr.steps())
        path = os.path.join(outdir, "kill_rank%d.json" % rank)
        with open(path, "w") as f:
            json.dump(obs, f)
            f.flush()
            os.fsync(f.fileno())

    for k in range(4):
        b = it.next()
        obs["idx"].append(np.asarray(b.index).tolist())
        obs["losses"].append(elastic_feed(step, mesh, b, dev))
        if k == 1:
            step.save_checkpoint(mgr, data_iter=it)
        dump()
    if rank == 1:
        dump(kill_t=time.time())
        with fi.host_loss_during_save(at=0):
            step.save_checkpoint(mgr, data_iter=it)
        dump(error="host_loss_did_not_fire")
        sys.exit(4)
    try:
        step.save_checkpoint(mgr, data_iter=it)
    except CheckpointError as e:
        dump(error=type(e).__name__, message=str(e), error_t=time.time())
        sys.exit(3)
    dump(error="commit_unexpectedly_succeeded")
    sys.exit(5)


def async_checks():
    """``dist_async`` (the reference's ``tests/async_worker.py``): each
    rank fits the shared weight of a linear regression through the
    asynchronous parameter host, rank r taking 20 + 15 r steps; nothing
    waits for the peers until the closing barriers."""
    store = kv.create("dist_async")
    rank, nw = store.rank, store.num_workers
    rng = np.random.RandomState(100 + rank)
    w_true = np.array([1.0, -2.0, 3.0], np.float32)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    y = X @ w_true
    store.init("w", mx.nd.array(np.zeros(3, np.float32), ctx=mx.cpu()))
    store.set_optimizer(mx.optimizer.SGD(learning_rate=0.05))
    steps = 20 + 15 * rank
    w = mx.nd.array(np.zeros(3, np.float32), ctx=mx.cpu())
    for _ in range(steps):
        store.pull("w", out=w)
        wv = w.asnumpy()
        grad = 2.0 / len(X) * X.T @ (X @ wv - y)
        store.push("w", mx.nd.array(grad.astype(np.float32), ctx=mx.cpu()))
    store.barrier()  # every push is in
    store.pull("w", out=w)
    store.barrier()  # every pull is done before rank 0 takes the host down
    store.close()
    return {"rank": np.int32(rank), "nw": np.int32(nw),
            "steps": np.int32(steps), "w": w.asnumpy(), "w_true": w_true}


def main():
    mode, outdir = sys.argv[1], sys.argv[2]
    platform = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    distributed.initialize(device=platform)
    dev = distributed.local_device(platform)
    if mode == "kvstore":
        out = kvstore_checks(dev)
    elif mode == "async":
        out = async_checks()
    elif mode.startswith("elastic"):
        mesh = make_mesh({"dp": -1}, devices=global_devices(platform))
        out = (elastic_save if mode == "elastic_save" else
               elastic_restore)(dev, mesh, outdir)
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
    if mode == "elastic_restore":
        elastic_kill(dev, mesh, outdir)


if __name__ == "__main__":
    main()
