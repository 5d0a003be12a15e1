"""Worker body of the port's model-parallel tests
(``tests/test_torch_{seq_parallel,pipeline,moe}.py``).

Each rank runs this script under ``tools/launch_torch.py`` (4 ranks over gloo
on the CPU); it imports only the port (never ``jax``).  The parent
writes the inputs (``<outdir>/inputs.npz``: weights, batches and
cotangents from numpy seeds, the JAX nets' initial weights) and runs the
JAX package's side meanwhile; each rank writes what it computed to
``<outdir>/rank<r>.npz``.  Modes:

- ``seq``: ``sharded_self_attention`` (ring and Ulysses, causal and not)
  at sp=4 (``{"sp": 4}``) and sp=2 (``{"dp": 2, "sp": 2}``), outputs and
  q/k/v gradients with the collectives each call made; the multi-axis
  meshes (coordinates, each axis's group, a sum over each axis); the
  LM of ``example/long_context/train_lm_torch.py`` at sp=2, ring and
  Ulysses, two steps of its update;
- ``pipeline``: ``pipeline_apply`` at pp=4 (output and gradients), one
  unit-lr step of the pipelined ``make_train_step`` at pp=4 and at
  dp=2 x pp=2, remat off and on, two steps of
  ``Trainer.make_fused_step(pipeline_stages=4)``, and a checkpoint of
  the pp=4 step restored at pp=2 (refused);
- ``moe``: ``moe_ffn_sharded`` at ep=2, the ``MoEFFN`` net's fused
  step at dp=2 x ep=2, the dp=2 x tp=2 step, and a checkpoint of the
  MoE step restored at the same topology and at dp=1 x ep=4 (refused).

    python tools/launch_torch.py -n 4 python tests/torch_mp_worker.py \\
        MODE OUTDIR cpu
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
import torch.distributed as dist

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import context, convert, gluon
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.contrib.nn import MoEFFN
from incubator_mxnet_tpu_torch.parallel import (CheckpointTopologyError, P,
                                                collectives, distributed,
                                                make_mesh, make_train_step,
                                                moe_ffn_sharded,
                                                pipeline_apply)
from incubator_mxnet_tpu_torch.parallel.mesh import global_devices
from incubator_mxnet_tpu_torch.parallel.ring_attention import \
    sharded_self_attention

#: the meshes whose layout the ``seq`` job records
LAYOUTS = [{"sp": 4}, {"dp": 2, "pp": 2}, {"dp": 2, "tp": 2},
           {"dp": 2, "ep": 2}, {"pp": 4}, {"ep": 4}, {"dp": -1, "sp": 2}]


def _lm_example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", os.path.join(REPO, "example", "long_context",
                                       "train_lm_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh(axes, platform="cpu"):
    return make_mesh(axes, devices=global_devices(platform))


def _t(inputs, key, grad=False):
    return torch.from_numpy(np.array(inputs[key])).requires_grad_(grad)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _calls():
    return np.asarray(json.dumps(collectives.call_counts(), sort_keys=True))


# ---------------------------------------------------------------------------
# seq
# ---------------------------------------------------------------------------

def lm_args(impl):
    """``train_lm_torch.py``'s arguments of the test's LM at sp=2."""
    return ["--device", "cpu", "--devices", "2", "--impl", impl, "--seq",
            "64", "--dim", "64", "--heads", "4", "--layers", "2",
            "--vocab", "64", "--batch", "2", "--steps", "2"]


def seq_mode(inputs, cases):
    out = {}
    meshes = {"sp4": _mesh({"sp": 4}), "sp2": _mesh({"dp": 2, "sp": 2})}
    for case in cases:
        name, mesh = case["name"], meshes[case["mesh"]]
        q, k, v = (_t(inputs, "%s.%s" % (name, t), True) for t in "qkv")
        cot = _t(inputs, name + ".cot")
        collectives.reset_call_counts()
        o = sharded_self_attention(q, k, v, mesh, seq_axis="sp",
                                   causal=case["causal"], impl=case["impl"])
        (o * cot).sum().backward()
        out[name + ".out"] = _np(o)
        for t, g in zip("qkv", (q, k, v)):
            out["%s.d%s" % (name, t)] = _np(g.grad)
        out[name + ".calls"] = _calls()
    for i, axes in enumerate(LAYOUTS):
        mesh = _mesh(axes)
        out["layout%d.coords" % i] = np.asarray(
            [mesh.coords[a] for a in mesh.axis_names])
        for a in mesh.axis_names:
            g = mesh.group(a)
            ranks = [distributed.process_index()] if g is None else \
                dist.get_process_group_ranks(g)
            out["layout%d.%s.ranks" % (i, a)] = np.asarray(sorted(ranks))
            out["layout%d.%s.sum" % (i, a)] = _np(collectives.allreduce(
                torch.tensor([float(distributed.process_index())]), a, mesh))
    tex = _lm_example()
    for impl in ("ring", "ulysses"):
        args = tex.parse_args(lm_args(impl))
        lm, tokens = tex.build(args, meshes["sp2"])
        step = tex.make_step(lm, args.lr)
        collectives.reset_call_counts()
        out["lm_%s.loss" % impl] = np.asarray(
            [float(step(tokens)) for _ in range(args.steps)])
        out["lm_%s.calls" % impl] = _calls()
        for n, t in convert.ordered_tensors(lm):
            out["lm_%s.%s" % (impl, n)] = _np(t)
    return out


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

FEAT = 16


def pipe_net(inputs, layers=4):
    with context.device_scope("cpu"):
        net = nn.HybridSequential()
        for _ in range(layers):
            net.add(nn.Dense(FEAT, in_units=FEAT, activation="tanh"))
    net.initialize(init=mx.init.Xavier())
    n = len(convert.ordered_tensors(net))
    convert.params_from_jax(net, [inputs["pipe.w%d" % i] for i in range(n)])
    return net


def _unit_lr_grads(step, net, x, y):
    before = [_np(t) for _, t in convert.ordered_tensors(net)]
    loss = float(step(x, y))
    after = [_np(t) for _, t in convert.ordered_tensors(net)]
    return loss, [b - a for b, a in zip(before, after)]


def pipeline_mode(inputs, outdir):
    out = {}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    pp4 = _mesh({"pp": 4})
    dp2pp2 = _mesh({"dp": 2, "pp": 2})
    ws, bs = _t(inputs, "apply.ws", True), _t(inputs, "apply.bs", True)
    x, cot = _t(inputs, "apply.x"), _t(inputs, "apply.cot")

    def stage_fn(params, h):
        w, b = params
        return torch.tanh(h @ w + b)

    collectives.reset_call_counts()
    o = pipeline_apply(stage_fn, (ws, bs), x, pp4, num_micro=4)
    (o * cot).sum().backward()
    out.update({"apply.out": _np(o), "apply.dws": _np(ws.grad),
                "apply.dbs": _np(bs.grad), "apply.calls": _calls()})
    x, y = _t(inputs, "pipe.x"), _t(inputs, "pipe.y")
    for name, mesh in (("pp4", pp4), ("dp2pp2", dp2pp2)):
        xl, yl = (mesh.local_slice(t) if "dp" in mesh.shape else t
                  for t in (x, y))
        for remat in (False, True):
            net = pipe_net(inputs)
            step = make_train_step(
                net, loss_fn, optimizer="sgd", learning_rate=1.0,
                device="cpu", mesh=mesh, pipeline_stages=mesh.shape["pp"],
                num_micro=4, pipeline_remat=remat)
            collectives.reset_call_counts()
            loss, grads = _unit_lr_grads(step, net, xl, yl)
            key = "%s_remat%d" % (name, remat)
            out[key + ".loss"] = np.float64(loss)
            out[key + ".calls"] = _calls()
            for i, g in enumerate(grads):
                out["%s.g%d" % (key, i)] = g
    net = pipe_net(inputs)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    step = trainer.make_fused_step(net, loss_fn, mesh=pp4, device="cpu",
                                   pipeline_stages=4, num_micro=4)
    out["trainer.loss"] = np.asarray([float(step(x, y)) for _ in range(2)])
    for i, (_, t) in enumerate(convert.ordered_tensors(net)):
        out["trainer.p%d" % i] = _np(t)
    # a checkpoint of the pp=4 step restored by a 2-stage step
    ckpt = os.path.join(outdir, "ckpt_pp")
    step.save_checkpoint(ckpt)
    other = make_train_step(pipe_net(inputs), loss_fn, optimizer="sgd",
                            learning_rate=0.1, momentum=0.9, device="cpu",
                            mesh=dp2pp2, pipeline_stages=2, num_micro=4)
    out["ckpt.refusal"] = _refusal(lambda: other.restore_checkpoint(ckpt))
    net = pipe_net(inputs)
    same = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9}).make_fused_step(
            net, loss_fn, mesh=pp4, device="cpu", pipeline_stages=4,
            num_micro=4)
    out["ckpt.restored"] = np.int64(same.restore_checkpoint(ckpt))
    for i, (_, t) in enumerate(convert.ordered_tensors(same.net)):
        out["ckpt.p%d" % i] = _np(t)
    return out


def _refusal(fn):
    try:
        fn()
    except CheckpointTopologyError as e:
        return np.asarray("CheckpointTopologyError: %s" % e)
    return np.asarray("no error")


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

MOE_ARGS = ("x", "gate_w", "w1", "b1", "w2", "b2")


def moe_net(inputs, prefix):
    mx.random.seed(9)
    with context.device_scope("cpu"):
        net = nn.HybridSequential()
        net.add(nn.Dense(8, in_units=8, activation="relu"),
                MoEFFN(16, 4, top_k=2, capacity_factor=2.0,
                       aux_loss_weight=1e-2, in_units=8),
                nn.Dense(4, in_units=8))
    net.initialize(init=mx.init.Xavier())
    n = len(convert.ordered_tensors(net))
    convert.params_from_jax(net, [inputs["%s.w%d" % (prefix, i)]
                                  for i in range(n)])
    return net


def tp_net(inputs):
    with context.device_scope("cpu"):
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=8, activation="relu"),
                nn.Dense(4, in_units=16))
    net.initialize(init=mx.init.Xavier())
    n = len(convert.ordered_tensors(net))
    convert.params_from_jax(net, [inputs["tp.w%d" % i] for i in range(n)])
    return net


def gathered(step):
    """The step's trained parameters whole: a sharded one all-gathered
    over its axis."""
    out = []
    for i, p in enumerate(step._gp):
        if i in step._shards:
            axis, dim = step._shards[i]
            p = collectives.allgather(p.detach(), axis, step.mesh, axis=dim)
        out.append(_np(p))
    return out


def _run(step, mesh, x, y, steps):
    xl, yl = mesh.local_slice(x), mesh.local_slice(y)
    collectives.reset_call_counts()
    losses = [float(step(xl, yl)) for _ in range(steps)]
    return np.asarray(losses), _calls()


def moe_mode(inputs, outdir):
    out = {}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    de = _mesh({"dp": 2, "ep": 2})
    args = [_t(inputs, "ffn." + a, True) for a in MOE_ARGS]
    cot = _t(inputs, "ffn.cot")
    collectives.reset_call_counts()
    o, aux = moe_ffn_sharded(*args, de, top_k=2, capacity_factor=2.0,
                             return_aux=True)
    ((o * cot).sum() + aux).backward()
    out.update({"ffn.out": _np(o), "ffn.aux": _np(aux),
                "ffn.calls": _calls()})
    for a, t in zip(MOE_ARGS, args):
        out["ffn.d" + a] = _np(t.grad)
    x, y = _t(inputs, "moe.x"), _t(inputs, "moe.y")
    net = moe_net(inputs, "moe")
    moe = net[1]
    step = make_train_step(net, loss_fn, optimizer="sgd", learning_rate=0.1,
                           device="cpu", mesh=de,
                           param_shardings=moe.expert_shardings("ep"))
    out["moe.expert_rows"] = np.int64(moe.expert_w1.shape[0])
    out["moe.loss"], out["moe.calls"] = _run(step, de, x, y, 4)
    for i, p in enumerate(gathered(step)):
        out["moe.p%d" % i] = p
    # the MoE step's checkpoint: restored at its topology, refused at ep=4
    ckpt = os.path.join(outdir, "ckpt_moe")
    step.save_checkpoint(ckpt)
    net2 = moe_net(inputs, "moe")
    again = make_train_step(net2, loss_fn, optimizer="sgd",
                            learning_rate=0.1, device="cpu", mesh=de,
                            param_shardings=net2[1].expert_shardings("ep"))
    out["ckpt.restored"] = np.int64(again.restore_checkpoint(ckpt))
    out["ckpt.same"] = np.bool_(all(
        np.array_equal(a, b) for a, b in zip(gathered(again),
                                             gathered(step))))
    e4 = _mesh({"dp": 1, "ep": 4})
    net4 = moe_net(inputs, "moe")
    wide = make_train_step(net4, loss_fn, optimizer="sgd",
                           learning_rate=0.1, device="cpu", mesh=e4,
                           param_shardings=net4[1].expert_shardings("ep"))
    out["ckpt.refusal"] = _refusal(lambda: wide.restore_checkpoint(ckpt))
    dt = _mesh({"dp": 2, "tp": 2})
    tnet = tp_net(inputs)
    tstep = make_train_step(tnet, loss_fn, optimizer="sgd",
                            learning_rate=0.1, device="cpu", mesh=dt,
                            param_shardings={
                                list(tnet[1].collect_params())[0]:
                                P("tp", None)})
    out["tp.rows"] = np.int64(tnet[1].weight.shape[0])
    xt, yt = _t(inputs, "tp.x"), _t(inputs, "tp.y")
    out["tp.loss"], out["tp.calls"] = _run(tstep, dt, xt, yt, 3)
    for i, p in enumerate(gathered(tstep)):
        out["tp.p%d" % i] = p
    return out


def main():
    mode, outdir = sys.argv[1], sys.argv[2]
    platform = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    distributed.initialize(device=platform)
    inputs = np.load(os.path.join(outdir, "inputs.npz"))
    if mode == "seq":
        with open(os.path.join(outdir, "cases.json")) as f:
            out = seq_mode(inputs, json.load(f))
    elif mode == "pipeline":
        out = pipeline_mode(inputs, outdir)
    else:
        out = moe_mode(inputs, outdir)
    out["rank"] = np.int32(distributed.process_index())
    distributed.barrier("done")
    np.savez(os.path.join(outdir, "rank%d.npz" % distributed.process_index()),
             **out)
    print("worker %d ok" % distributed.process_index(), flush=True)


if __name__ == "__main__":
    main()
