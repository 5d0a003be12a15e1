#!/usr/bin/env python
"""Long-context language model on one CUDA card (PyTorch port of
``train_lm.py``).

The same decoder-only transformer, weights, synthetic task and update as
the JAX example, with causal attention through the port's flash
attention: on the card its hand-written kernels (forward, dQ, dK/dV), on
the CPU their plain versions.  On one device the JAX example's
``sharded_self_attention(..., impl="ulysses")`` is that same function (its
all-to-alls are the identity); sequence parallelism over several cards
waits for ROADMAP A8 item c, so there
is no ``--devices`` or ``--impl`` here.

On the card (from the repository root):

    python3 example/long_context/train_lm_torch.py --seq 2048 --dim 1024

On the CPU, at a small size:

    python3 example/long_context/train_lm_torch.py --device cpu --seq 64 \\
        --dim 64 --heads 4
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
    (from :func:`build_params` or the JAX example's)."""

    def __init__(self, vocab, dim, heads, n_layers, ffn_mult=4, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError("dim %d is not a multiple of heads %d"
                             % (dim, heads))
        dev = context.resolve(device)
        self.heads = heads
        self.n_layers = n_layers

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
        # backward of indexing when tokens repeat (PERF.md)
        x = F.embedding(tokens, self.embed)
        b, s, dim = x.shape
        h_, d_ = self.heads, dim // self.heads
        for li in range(self.n_layers):
            p = getattr(self, "l%d" % li)
            h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(b, s, h_, d_).transpose(1, 2)
            k = (h @ p["wk"]).reshape(b, s, h_, d_).transpose(1, 2)
            v = (h @ p["wv"]).reshape(b, s, h_, d_).transpose(1, 2)
            att = flash_attention(q, k, v, causal=True)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    dev = context.resolve(args.device)
    print("device: %s" % (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"))
    rng = np.random.RandomState(0)
    lm = LongContextLM(args.vocab, args.dim, args.heads, args.layers,
                       device=dev)
    convert.lm_params_from_jax(
        lm, build_params(rng, args.vocab, args.dim, args.layers))
    tokens = torch.from_numpy(
        synthetic_tokens(rng, args.vocab, args.batch, args.seq)).to(dev)
    step = make_step(lm, 0.05)

    first = last = None
    for i in range(args.steps):
        t0 = time.time()
        loss = float(step(tokens))   # float() waits for the card
        if first is None:
            first = loss
        last = loss
        print("step %2d  loss %.4f  (%.2fs)" % (i, loss, time.time() - t0))
    assert last < first, (first, last)
    print("PASS: loss %.4f -> %.4f over seq %d on %s (flash attention)"
          % (first, last, args.seq, dev))


if __name__ == "__main__":
    main()
