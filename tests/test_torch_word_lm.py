"""``example/rnn/word_lm/train_torch.py`` against the JAX example
(``train.py``), f32 on the CPU.

The JAX example's ``WordLM`` and loop (``autograd.record()``,
``SoftmaxCrossEntropyLoss``, ``Trainer("sgd")``, ``step(batch)``) and the
port's, at vocab 64, embedding 16, hidden 32, 2 LSTM layers, batch 4,
bptt 8, lr 1.0 on the example's synthetic corpus, the port's weights
copied from the reference's by position (the names agree): the losses
of the first 5 steps within 1e-5 (relative; measured at most 1.2e-7)
and every parameter after them within 1e-5 of its largest magnitude
(measured at most 1.7e-7).  ``main`` trains on the CPU when asked.
"""
import importlib.util
import os

import numpy as np

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--vocab", "64", "--emsize", "16", "--nhid",
         "32", "--nlayers", "2", "--batch-size", "4", "--bptt", "8", "--lr",
         "1.0"]
STEPS = 5


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_first_steps_match_reference():
    jex = _load("_word_lm_jax", "example/rnn/word_lm/train.py")
    tex = _load("_word_lm_torch", "example/rnn/word_lm/train_torch.py")
    args = tex.parse_args(SMALL)
    data = tex.corpus_rows(args)
    corpus = jex.synthetic_corpus(args.vocab,
                                  args.batch_size * args.bptt * 20)
    assert np.array_equal(data.reshape(-1),
                          corpus[:data.size])

    jmx.random.seed(0)
    jnet = jex.WordLM(args.vocab, args.emsize, args.nhid, args.nlayers)
    jnet.initialize(init=jmx.init.Xavier())
    jnet.shape_init((args.batch_size, args.bptt), dtype="int64")
    jnet.hybridize()
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                 {"learning_rate": args.lr})
    jloss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()

    dev = tmx.cpu()
    tnet, ttrainer, tloss_fn = tex.build(args, dev)
    convert.params_from_jax(tnet, [p.data().asnumpy() for p in
                                   jnet.collect_params().values()])
    assert convert.canonical_names(list(tnet.collect_params())) == \
        convert.canonical_names(list(jnet.collect_params()))

    jl, tl = [], []
    for lo in tex.windows(data, args.bptt)[:STEPS]:
        x = jmx.nd.array(data[:, lo:lo + args.bptt].astype(np.float32))
        y = jmx.nd.array(
            data[:, lo + 1:lo + args.bptt + 1].astype(np.float32))
        with jmx.autograd.record():
            logits = jnet(x)
            loss = jloss_fn(logits.reshape((-1, args.vocab)),
                            y.reshape((-1,))).mean()
        loss.backward()
        jtrainer.step(args.batch_size)
        jl.append(float(loss.asscalar()))
        tx, ty = tex.batch(data, lo, args.bptt, dev)
        tl.append(float(tex.train_step(tnet, ttrainer, tloss_fn, tx, ty,
                                       args).asscalar()))
    assert len(tl) == STEPS
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl, jl)
    for a, b in zip(tnet.collect_params().values(),
                    jnet.collect_params().values()):
        assert _rel(a.data().asnumpy(), b.data().asnumpy()) <= 1e-5


def test_main_trains_on_cpu():
    tex = _load("_word_lm_torch_main", "example/rnn/word_lm/train_torch.py")
    losses = tex.main(SMALL + ["--epochs", "1"])
    assert len(losses) == 19 and np.isfinite(losses).all()
    assert abs(losses[0] - np.log(64)) < 0.05
