#!/usr/bin/env python
"""Long-context language model with sequence parallelism (PyTorch port of
``train_lm.py``).

The same decoder-only transformer, weights, synthetic task and update as
the JAX example.  With ``--devices N`` (N > 1) it runs as N processes
started by ``tools/launch.py -n N``: every rank holds the whole model and
the whole batch, and each layer's causal attention runs through
``parallel.ring_attention.sharded_self_attention`` over the ``sp`` axis
of ``make_mesh({"sp": N})`` (``--impl ring``: K/V blocks rotating around
the ranks; ``--impl ulysses``: all-to-all to heads, the port's flash
attention on the whole sequence, and back).  With ``--devices 0`` or 1
it is one process whose attention is the port's flash attention (on one
device the JAX example's ``impl="ulysses"`` is that same function).  On
the card the flash kernels are the hand-written K4-K6; on the CPU their
plain versions run.

On the card (from the repository root):

    python3 example/long_context/train_lm_torch.py --seq 2048 --dim 1024
    python3 tools/launch.py -n 2 python3 \
        example/long_context/train_lm_torch.py --devices 2 --impl ulysses \
        --seq 2048 --dim 1024 --batch 4 --lr 0.01

On the CPU, at a small size:

    python3 example/long_context/train_lm_torch.py --device cpu --seq 64 \
        --dim 64 --heads 4
    OMP_NUM_THREADS=2 python3 tools/launch.py -n 2 python3 \
        example/long_context/train_lm_torch.py --device cpu --devices 2 \
        --impl ring --seq 64 --dim 64 --heads 4
"""
import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.parallel import flash_attention
from incubator_mxnet_tpu_torch.parallel.ring_attention import \
    sharded_self_attention

_LAYER_KEYS = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b",
               "w1", "w2")


def build_params(rng, vocab, dim, n_layers, ffn_mult=4):
    """The example's weights as numpy: the same draws, in the same order,
    as ``train_lm.py``'s ``build_params``."""

    def lin(i, o):
        return rng.normal(0, (2.0 / (i + o)) ** 0.5, (i, o)).astype(np.float32)

    params = {"embed": rng.normal(0, 0.02, (vocab, dim)).astype(np.float32)}
    for li in range(n_layers):
        params["l%d" % li] = {
            "ln1_g": np.ones(dim, np.float32),
            "ln1_b": np.zeros(dim, np.float32),
            "wq": lin(dim, dim), "wk": lin(dim, dim), "wv": lin(dim, dim),
            "wo": lin(dim, dim),
            "ln2_g": np.ones(dim, np.float32),
            "ln2_b": np.zeros(dim, np.float32),
            "w1": lin(dim, dim * ffn_mult), "w2": lin(dim * ffn_mult, dim),
        }
    params["out"] = lin(dim, vocab)
    return params


def _layer_norm(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * g + b


class LongContextLM(torch.nn.Module):
    """The example's decoder: token embedding, ``n_layers`` pre-LN blocks
    (causal multi-head attention, a tanh-GELU MLP of width
    ``ffn_mult * dim``), an output projection.  Parameters are f32 and
    keep the example's key names (``embed``, ``l0.wq``, ..., ``out``);
    they start at zero: load them with :func:`convert.lm_params_from_jax`
    (from :func:`build_params` or the JAX example's).  With a ``mesh``
    the attention is sequence-parallel over its ``sp`` axis by
    ``impl``."""

    def __init__(self, vocab, dim, heads, n_layers, ffn_mult=4, device=None,
                 mesh=None, impl="ring"):
        super().__init__()
        if dim % heads:
            raise ValueError("dim %d is not a multiple of heads %d"
                             % (dim, heads))
        dev = context.resolve(device)
        self.heads = heads
        self.n_layers = n_layers
        self.mesh = mesh
        self.impl = impl

        def zeros(*shape):
            return torch.nn.Parameter(torch.zeros(shape, device=dev))

        self.embed = zeros(vocab, dim)
        shapes = {"ln1_g": (dim,), "ln1_b": (dim,), "wq": (dim, dim),
                  "wk": (dim, dim), "wv": (dim, dim), "wo": (dim, dim),
                  "ln2_g": (dim,), "ln2_b": (dim,),
                  "w1": (dim, dim * ffn_mult), "w2": (dim * ffn_mult, dim)}
        for li in range(n_layers):
            setattr(self, "l%d" % li, torch.nn.ParameterDict(
                {k: zeros(*shapes[k]) for k in _LAYER_KEYS}))
        self.out = zeros(dim, vocab)

    def forward(self, tokens):
        """(B, S) int64 tokens -> (B, S, vocab) logits."""
        # the gather params["embed"][tokens]; F.embedding's backward sums
        # repeated tokens by segments, much faster on the card than the
        # backward of indexing when tokens repeat (PERF.md).  Over a mesh
        # every rank computes this gradient alone and the replicas must
        # stay bit-equal: F.embedding's backward is not deterministic on
        # the card (its sums of repeated rows change from call to call),
        # indexing's (rows sorted, then summed in order) is
        if self.mesh is None:
            x = F.embedding(tokens, self.embed)
        else:
            x = self.embed[tokens]
        b, s, dim = x.shape
        h_, d_ = self.heads, dim // self.heads
        for li in range(self.n_layers):
            p = getattr(self, "l%d" % li)
            h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(b, s, h_, d_).transpose(1, 2)
            k = (h @ p["wk"]).reshape(b, s, h_, d_).transpose(1, 2)
            v = (h @ p["wv"]).reshape(b, s, h_, d_).transpose(1, 2)
            if self.mesh is None:
                att = flash_attention(q, k, v, causal=True)
            else:
                att = sharded_self_attention(q, k, v, self.mesh,
                                             seq_axis="sp", causal=True,
                                             impl=self.impl)
            att = att.transpose(1, 2).reshape(b, s, dim)
            x = x + att @ p["wo"]
            h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
            # jax.nn.gelu's default is the tanh form; torch's is erf
            x = x + F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]
        return x @ self.out


def loss_fn(lm, tokens):
    """Next-token cross-entropy of the example: predict ``tokens[:, 1:]``
    from ``tokens[:, :-1]``, mean over every position."""
    logits = lm(tokens[:, :-1])
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, tokens[:, 1:, None]).mean()


def make_step(lm, lr, momentum=0.9):
    """The example's update, ``m = momentum * m + g; p -= lr * m`` (heavy
    ball without weight decay or rescaling; not MXNet's sgd form).
    Returns ``step(tokens) -> loss``; the momenta start at zero and live
    beside the parameters."""
    params = list(lm.parameters())
    moms = [torch.zeros_like(p) for p in params]

    def step(tokens):
        loss = loss_fn(lm, tokens)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, m, g in zip(params, moms, grads):
                m.mul_(momentum).add_(g)
                p.sub_(lr * m)
        return loss.detach()

    return step


def synthetic_tokens(rng, vocab, batch, seq):
    """The example's learnable task: each row starts at a random token and
    continues with ``next = (token * 2 + 1) mod vocab``; (batch, seq + 1)
    int64."""
    base = rng.randint(0, vocab, (batch, 1))
    rows = [base]
    for _ in range(seq):
        rows.append((rows[-1] * 2 + 1) % vocab)
    return np.concatenate(rows, axis=1).astype(np.int64)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--devices", type=int, default=0,
                    help="sp axis size: the processes of tools/launch.py "
                         "(0 or 1: one process)")
    ap.add_argument("--impl", default="ring", choices=["ring", "ulysses"])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def build_mesh(args):
    """``make_mesh({"sp": N})`` over the launched processes for
    ``--devices N`` (N > 1), else None (one process)."""
    if args.devices <= 1:
        return None
    from incubator_mxnet_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(device=args.device)
    if distributed.process_count() != args.devices:
        raise ValueError(
            "--devices %d needs %d processes (tools/launch.py -n %d), "
            "have %d" % (args.devices, args.devices, args.devices,
                         distributed.process_count()))
    return make_mesh({"sp": args.devices},
                     devices=[distributed.local_device(args.device, r)
                              for r in range(args.devices)])


def build(args, mesh=None):
    """The example's model with its weights (numpy seed 0) and its tokens
    on this process's device: ``(lm, tokens)``."""
    dev = context.resolve(args.device) if mesh is None \
        else mesh.local_device
    rng = np.random.RandomState(0)
    lm = LongContextLM(args.vocab, args.dim, args.heads, args.layers,
                       device=dev, mesh=mesh, impl=args.impl)
    convert.lm_params_from_jax(
        lm, build_params(rng, args.vocab, args.dim, args.layers))
    tokens = torch.from_numpy(
        synthetic_tokens(rng, args.vocab, args.batch, args.seq)).to(dev)
    return lm, tokens


def main(argv=None):
    """Train ``--steps`` steps; returns their losses as floats."""
    args = parse_args(argv)
    mesh = build_mesh(args)
    lm, tokens = build(args, mesh)
    dev = tokens.device
    print("device: %s  mesh: %s" % (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "sp=%d (%s attention)" % (args.devices, args.impl) if mesh
        else "none (flash attention)"))
    step = make_step(lm, args.lr)

    losses = []
    for i in range(args.steps):
        t0 = time.time()
        loss = float(step(tokens))   # float() waits for the card
        losses.append(loss)
        print("step %2d  loss %.4f  (%.2fs)" % (i, loss, time.time() - t0))
    first, last = losses[0], losses[-1]
    assert last < first, (first, last)
    where = "sp=%d (%s attention)" % (args.devices, args.impl) if mesh \
        else "%s (flash attention)" % dev
    print("PASS: loss %.4f -> %.4f over seq %d on %s"
          % (first, last, args.seq, where))
    return losses


if __name__ == "__main__":
    main()
