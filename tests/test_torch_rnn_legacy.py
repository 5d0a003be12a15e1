"""The port's legacy ``mx.rnn`` cells, ``BucketSentenceIter``, the RNN
checkpoint helpers and ``BucketingModule`` against the JAX package's,
f32 on the CPU.

- Cells unrolled into ``mx.sym`` graphs and bound by each package's
  executor: ``FusedRNNCell`` (LSTM, 2 layers, two directions, with its
  next states; GRU), a ``SequentialRNNCell`` of an ``LSTMCell`` and a
  ``BidirectionalCell`` of ``GRUCell``s, and a stack of a
  ``ResidualCell``, a ``DropoutCell`` and a ``ZoneoutCell`` (forward
  outside training: no drop).  The same arguments (names, order,
  inferred shapes), outputs within 1e-5 and gradients within 1e-4 of
  each tensor's largest magnitude (measured: at most 4.0e-7, outputs and
  gradients alike).
- ``FusedRNNCell.unpack_weights`` gives the reference's names and values
  bit for bit, ``pack_weights`` inverts it, and ``unfuse()`` gives the
  reference's arguments and the fused cell's outputs (1e-5; measured
  2.4e-7).
- ``BucketSentenceIter``: with Python's and numpy's seeds set alike,
  the same batches, bucket keys and descriptors over two epochs, NT and
  TN.  ``save_rnn_checkpoint``/``load_rnn_checkpoint`` cross the
  packages both ways.
- ``BucketingModule`` over an unrolled ``LSTMCell`` language model
  (``example/rnn/bucketing``'s ``sym_gen``), three sgd steps across two
  buckets from the same weights: outputs and parameters after each step
  within 1e-5 of the largest magnitude (measured at most 1.6e-7).
"""
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

CPU = tmx.cpu()
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cells(mx, kind):
    r = mx.rnn
    if kind == "fused_lstm":
        return r.FusedRNNCell(4, num_layers=2, mode="lstm",
                              bidirectional=True, prefix="lstm_",
                              get_next_state=True)
    if kind == "fused_gru":
        return r.FusedRNNCell(4, mode="gru", prefix="gru_")
    stack = r.SequentialRNNCell()
    if kind == "stack":
        stack.add(r.LSTMCell(4, prefix="l0_"))
        stack.add(r.BidirectionalCell(r.GRUCell(3, prefix="bl_"),
                                      r.GRUCell(3, prefix="br_")))
    else:
        stack.add(r.ResidualCell(r.RNNCell(5, prefix="res_")))
        stack.add(r.DropoutCell(0.5))
        stack.add(r.ZoneoutCell(r.GRUCell(5, prefix="z_"), 0.5, 0.5))
    return stack


def _unroll(mx, kind, layout="NTC"):
    with mx.name.NameManager():
        cell = _cells(mx, kind)
        out, states = cell.unroll(3, mx.sym.Variable("data"), layout=layout,
                                  merge_outputs=True)
        return mx.sym.Group([out] + list(states)), cell


@pytest.mark.parametrize("kind,train", [
    ("fused_lstm", True), ("fused_gru", True), ("stack", True),
    ("modifiers", False)])
def test_cells_bound_through_sym_match_reference(kind, train):
    jsym, _ = _unroll(jmx, kind)
    tsym, _ = _unroll(tmx, kind)
    names = jsym.list_arguments()
    assert tsym.list_arguments() == names
    jshapes = jsym.infer_shape(data=(2, 3, 5))
    tshapes = tsym.infer_shape(data=(2, 3, 5))
    assert [[tuple(s) for s in part] for part in tshapes] == \
        [[tuple(s) for s in part] for part in jshapes]
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(names, jshapes[0])}
    results = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        ctx = kw.get("ctx", jmx.cpu())
        exe = (jsym if mx is jmx else tsym).bind(
            ctx, {k: mx.nd.array(v, **kw) for k, v in args.items()},
            args_grad={k: mx.nd.zeros(v.shape, **kw)
                       for k, v in args.items()})
        outs = [o.asnumpy() for o in exe.forward(is_train=train)]
        grads = []
        if train:
            exe.backward([mx.nd.array(np.cos(np.arange(o.size)).reshape(
                o.shape).astype(np.float32), **kw) for o in outs])
            grads = [exe.grad_dict[n].asnumpy() for n in names]
        results.append((outs, grads))
    (jo, jg), (to, tg) = results
    for a, b in zip(to, jo):
        assert a.shape == b.shape and _rel(a, b) <= OUT_TOL, _rel(a, b)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape and _rel(a, b) <= GRAD_TOL, _rel(a, b)


def test_fused_unpack_pack_and_unfuse():
    h, layers = 3, 2
    size = tmx.ops.rnn.rnn_param_size(layers, 5, h, "lstm", True)
    flat = np.random.RandomState(1).uniform(-1, 1, size).astype(np.float32)
    jcell = jmx.rnn.FusedRNNCell(h, layers, "lstm", True, prefix="f_")
    tcell = tmx.rnn.FusedRNNCell(h, layers, "lstm", True, prefix="f_")
    jargs = jcell.unpack_weights({"f_parameters": jmx.nd.array(flat)})
    targs = tcell.unpack_weights({"f_parameters": tmx.nd.array(flat,
                                                               ctx=CPU)})
    assert list(targs) == list(jargs)
    for k in jargs:
        assert np.array_equal(targs[k].asnumpy(), jargs[k].asnumpy()), k
    assert np.array_equal(tcell.pack_weights(targs)["f_parameters"]
                          .asnumpy(), flat)
    tsym, fused = _unroll(tmx, "fused_lstm")
    with tmx.name.NameManager():
        unfused = fused.unfuse()
        usym, _ = unfused.unroll(3, tmx.sym.Variable("data"),
                                 merge_outputs=True)
    with jmx.name.NameManager():
        jfused = _cells(jmx, "fused_lstm")
        jusym, _ = jfused.unfuse().unroll(3, jmx.sym.Variable("data"),
                                          merge_outputs=True)
    assert usym.list_arguments() == jusym.list_arguments()
    rng = np.random.RandomState(2)
    x = tmx.nd.array(rng.uniform(-1, 1, (2, 3, 5)).astype(np.float32),
                     ctx=CPU)
    psize = tmx.ops.rnn.rnn_param_size(2, 5, 4, "lstm", True)
    packed = {"lstm_parameters": tmx.nd.array(
        rng.uniform(-0.5, 0.5, psize).astype(np.float32), ctx=CPU)}
    fused_out = tsym.eval(ctx=CPU, data=x, **packed)[0].asnumpy()
    args = fused.unpack_weights(packed)
    unfused_out = usym.eval(ctx=CPU, data=x, **args).asnumpy()
    assert _rel(unfused_out, fused_out) <= OUT_TOL


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_reference(layout):
    rng = np.random.RandomState(3)
    words = ["w%d" % i for i in range(20)]
    sentences = [[words[j] for j in rng.randint(0, 20, rng.randint(2, 9))]
                 for _ in range(60)]
    coded, vocab = tmx.rnn.encode_sentences(sentences, start_label=1)
    jcoded, jvocab = jmx.rnn.encode_sentences(sentences, start_label=1)
    assert coded == jcoded and vocab == jvocab
    iters = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        random.seed(4)
        np.random.seed(4)
        iters.append(mx.rnn.BucketSentenceIter(
            coded, 4, buckets=[4, 6, 8], invalid_label=0, layout=layout,
            **kw))
    jit, tit = iters
    assert tit.default_bucket_key == jit.default_bucket_key == 8
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for epoch in range(2):
        if epoch:
            random.seed(5)
            np.random.seed(5)
            jit.reset()
            random.seed(5)
            np.random.seed(5)
            tit.reset()
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) > 4
        keys = set()
        for a, b in zip(tb, jb):
            assert a.bucket_key == b.bucket_key
            keys.add(a.bucket_key)
            assert [tuple(d) for d in a.provide_data] == \
                [tuple(d) for d in b.provide_data]
            assert np.array_equal(a.data[0].asnumpy(), b.data[0].asnumpy())
            assert np.array_equal(a.label[0].asnumpy(),
                                  b.label[0].asnumpy())
        assert len(keys) > 1


def test_rnn_checkpoint_crosses_packages(tmp_path):
    psize = tmx.ops.rnn.rnn_param_size(1, 3, 2, "gru", False)
    flat = np.random.RandomState(6).uniform(-1, 1, psize).astype(np.float32)
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        cell_s = src.rnn.FusedRNNCell(2, mode="gru", prefix="g_")
        cell_d = dst.rnn.FusedRNNCell(2, mode="gru", prefix="g_")
        with src.name.NameManager():
            sym, _ = cell_s.unroll(2, src.sym.Variable("data"),
                                   merge_outputs=True)
        prefix = str(tmp_path / ("from_" + src.__name__[-5:]))
        kw = {"ctx": CPU} if src is tmx else {}
        src.rnn.save_rnn_checkpoint(
            cell_s, prefix, 1, sym, {"g_parameters": src.nd.array(flat, **kw)},
            {})
        kw = {"ctx": CPU} if dst is tmx else {}
        _, arg, _ = dst.rnn.load_rnn_checkpoint(cell_d, prefix, 1, **kw)
        assert np.array_equal(arg["g_parameters"].asnumpy(), flat)


def _sym_gen(mx, vocab, hidden):
    """``example/rnn/bucketing/lstm_bucketing.py``'s ``sym_gen``: embed,
    an unrolled ``LSTMCell`` stack, a softmax head over every step."""
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(hidden, prefix="lstm_l0_"))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=vocab,
                                 output_dim=hidden, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def test_bucketing_module_matches_reference():
    vocab, hidden, batch = 11, 4, 2
    rng = np.random.RandomState(7)
    mods = []
    for mx, kw in ((jmx, {}), (tmx, {"context": CPU})):
        with mx.name.NameManager():
            mod = mx.mod.BucketingModule(_sym_gen(mx, vocab, hidden),
                                         default_bucket_key=4, **kw)
            mod.bind(data_shapes=[("data", (batch, 4))],
                     label_shapes=[("softmax_label", (batch, 4))])
        mods.append(mod)
    jmod, tmod = mods
    jmod.init_params(initializer=jmx.init.Zero())
    arg, _ = jmod.get_params()
    start = {k: rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
             for k, v in arg.items()}
    jmod.set_params({k: jmx.nd.array(v) for k, v in start.items()}, {})
    tmod.init_params(arg_params=convert.ndarrays_from_numpy(start, CPU))
    for mod in mods:
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
    for key in (4, 3, 4):
        x = rng.randint(0, vocab, (batch, key)).astype(np.float32)
        y = rng.randint(0, vocab, (batch, key)).astype(np.float32)
        outs = []
        for mx, mod, kw in ((jmx, jmod, {}), (tmx, tmod, {"ctx": CPU})):
            descs = ([mx.io.DataDesc("data", (batch, key))],
                     [mx.io.DataDesc("softmax_label", (batch, key))])
            mod.forward_backward(mx.io.DataBatch(
                [mx.nd.array(x, **kw)], [mx.nd.array(y, **kw)],
                bucket_key=key, provide_data=descs[0],
                provide_label=descs[1]))
            mod.update()
            outs.append([mod.get_outputs()[0].asnumpy()] + [
                v.asnumpy() for _, v in sorted(mod.get_params()[0].items())])
        for a, b in zip(outs[1], outs[0]):
            assert a.shape == b.shape and _rel(a, b) <= OUT_TOL, _rel(a, b)
    assert sorted(tmod._buckets) == [3, 4]
    tmod.switch_to(4)
    assert tmod.symbol.list_arguments() == jmod.symbol.list_arguments()
