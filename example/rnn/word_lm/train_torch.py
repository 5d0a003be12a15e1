#!/usr/bin/env python
"""LSTM language model on one CUDA card (PyTorch port of ``train.py``):
``nn.Embedding`` -> ``gluon.rnn.LSTM`` (the fused ``RNN`` op, cuDNN on
the card) -> ``nn.Dense(flatten=False)``, trained by truncated BPTT with
``autograd.record()``, ``SoftmaxCrossEntropyLoss`` and
``gluon.Trainer("sgd")`` on the JAX script's synthetic Markov corpus.
The same model, corpus, flags and defaults as the JAX script, plus
``--device`` and the widths ``--emsize``/``--nhid``/``--nlayers`` (the
upstream script's flag names; the defaults are the JAX script's 64, 128
and 2).  ``main(argv)`` returns the per-step losses.

On the card, at the upstream medium model's widths (from the repository
root):

    python3 example/rnn/word_lm/train_torch.py --vocab 10000 --emsize 650 \\
        --nhid 650 --batch-size 32 --bptt 35 --epochs 1

On the CPU:

    python3 example/rnn/word_lm/train_torch.py --device cpu --epochs 1
"""
import argparse
import logging
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, context, gluon, nd
from incubator_mxnet_tpu_torch.gluon import nn, rnn


class WordLM(gluon.HybridBlock):
    """Embedding -> fused LSTM (NTC) -> a Dense head over every
    position."""

    def __init__(self, vocab, embed=64, hidden=128, layers=2, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.embedding = nn.Embedding(vocab, embed)
            self.lstm = rnn.LSTM(hidden, num_layers=layers, layout="NTC")
            self.decoder = nn.Dense(vocab, flatten=False)

    def hybrid_forward(self, F, x):  # noqa: N803
        return self.decoder(self.lstm(self.embedding(x)))


def synthetic_corpus(vocab, n_tokens, seed=0):
    """Markov-ish synthetic token stream (learnable structure)."""
    rng = np.random.RandomState(seed)
    toks = [0]
    for _ in range(n_tokens - 1):
        toks.append((toks[-1] * 7 + rng.randint(0, 3)) % vocab)
    return np.asarray(toks, np.int64)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--emsize", type=int, default=64)
    ap.add_argument("--nhid", type=int, default=128)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--bptt", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def corpus_rows(args):
    """The corpus as ``batch_size`` rows, as the JAX script cuts it."""
    corpus = synthetic_corpus(args.vocab, args.batch_size * args.bptt * 20)
    n = len(corpus) // args.batch_size * args.batch_size
    return corpus[:n].reshape(args.batch_size, -1)


def build(args, device):
    """``(net, trainer, loss_fn)`` on ``device``: the net Xavier-initialized
    after ``random.seed(0)``, its widths resolved at (batch, bptt)."""
    mx.random.seed(0)
    with context.device_scope(device):
        net = WordLM(args.vocab, args.emsize, args.nhid, args.nlayers)
    net.initialize(init=mx.init.Xavier())
    net.shape_init((args.batch_size, args.bptt), dtype="int64")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr})
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss()


def windows(data, bptt):
    """The (start of input, start of target) windows of one epoch."""
    return list(range(0, data.shape[1] - bptt - 1, bptt))


def train_step(net, trainer, loss_fn, x, y, args):
    """One truncated-BPTT step on the (batch, bptt) arrays ``x``, ``y``;
    returns the mean loss as an NDArray."""
    with autograd.record():
        logits = net(x)
        loss = loss_fn(logits.reshape((-1, args.vocab)),
                       y.reshape((-1,))).mean()
    loss.backward()
    trainer.step(args.batch_size)
    return loss


def batch(data, lo, bptt, device):
    """Input and target windows at ``lo`` as f32 NDArrays on ``device``."""
    x = nd.array(data[:, lo:lo + bptt].astype(np.float32), ctx=device)
    y = nd.array(data[:, lo + 1:lo + bptt + 1].astype(np.float32),
                 ctx=device)
    return x, y


def main(argv=None):
    """Train ``--epochs`` epochs; returns the per-step losses."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = context.resolve(args.device)
    data = corpus_rows(args)
    net, trainer, loss_fn = build(args, dev)
    losses = []
    for epoch in range(args.epochs):
        total, nb = 0.0, 0
        for lo in windows(data, args.bptt):
            x, y = batch(data, lo, args.bptt, dev)
            loss = train_step(net, trainer, loss_fn, x, y, args)
            losses.append(float(loss.asscalar()))
            total += losses[-1]
            nb += 1
        logging.info("epoch %d  loss %.3f  ppl %.1f", epoch, total / nb,
                     math.exp(total / nb))
    return losses


if __name__ == "__main__":
    main()
