"""The port's ``gluon.rnn`` layers and cells, ``nn.Embedding``,
``nn.Sequential`` and the ``Lambda``s against the JAX package's, f32 on
the CPU, weights carried across by position (``convert.params_from_jax``).

- ``LSTM`` (2 layers, two directions, TNC; 1 layer, NTC, with begin
  states), ``GRU`` (NTC, with begin states) and ``RNN`` (tanh, TNC): the output, the returned
  states and the gradients of the input and of every parameter (through
  ``_flat_params``' concatenation) inside ``autograd.record()``.  Limits:
  outputs 1e-5 and gradients 1e-4 of each tensor's largest magnitude
  (measured: at most 2.9e-7, outputs and gradients alike).
- Cells through ``unroll`` in both layouts: ``RNNCell`` (relu, with
  ``valid_length``), ``LSTMCell``, ``GRUCell`` (``merge_outputs=False``),
  ``SequentialRNNCell`` of an ``LSTMCell``, a ``DropoutCell`` (recorded
  in predict mode: no drop) and a ``ResidualCell``, and a
  ``BidirectionalCell`` of two ``RNNCell``s; same limits (measured: at
  most 2.7e-7).  ``ZoneoutCell``: rates 0 give the
  base cell; otherwise each output is the new or the previous one.
- ``Embedding``: rows at float indices, a negative index counting from
  the end and out-of-range indices giving NaN rows (``jnp.take``'s
  fill), and the dense gradient (bit for bit).
- ``Sequential`` with a ``Dense``, a named ``HybridLambda("tanh")`` and
  a ``Lambda("relu")`` (1e-6; measured 9.9e-8), ``begin_state`` shapes
  and device.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert

CPU = tmx.cpu()
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _carry(jnet, tnet, seed=5):
    """Uniform(-0.5, 0.5) numpy draws into both nets (drawn here: the
    reference's own initializers cost a compile per shape)."""
    rng = np.random.RandomState(seed)
    arrays = [rng.uniform(-0.5, 0.5, p.shape).astype(np.float32)
              for p in jnet.collect_params().values()]
    for p, a in zip(jnet.collect_params().values(), arrays):
        p.set_data(jmx.nd.array(a))
    convert.params_from_jax(tnet, arrays)


def _grads(net):
    return [p.grad().asnumpy() for p in net.collect_params().values()]


def _run(mx, net, x, states, fn, ctx=None, train_mode=True):
    """``fn(net, x, states)`` recorded; backward of the sum of squares of
    every output; returns (outputs as numpy, input gradient)."""
    kw = {} if ctx is None else {"ctx": ctx}
    xa = mx.nd.array(x, **kw)
    xa.attach_grad()
    sa = None if states is None else [mx.nd.array(s, **kw) for s in states]
    with mx.autograd.record(train_mode=train_mode):
        out = fn(net, xa, sa)
        flat = []
        for o in out if isinstance(out, (tuple, list)) else [out]:
            flat.extend(o if isinstance(o, (tuple, list)) else [o])
        loss = sum((o * o).sum() for o in flat)
    loss.backward()
    return [o.asnumpy() for o in flat], xa.grad.asnumpy()


def _compare(jnet, tnet, x, states, fn, train_mode=True):
    _carry(jnet, tnet)
    jo, jg = _run(jmx, jnet, x, states, fn, train_mode=train_mode)
    to, tg = _run(tmx, tnet, x, states, fn, CPU, train_mode=train_mode)
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        assert a.shape == b.shape and _rel(a, b) <= OUT_TOL, _rel(a, b)
    for a, b in zip([tg] + _grads(tnet), [jg] + _grads(jnet)):
        assert a.shape == b.shape and _rel(a, b) <= GRAD_TOL, _rel(a, b)


@pytest.mark.parametrize("cls,kw,layout,with_states", [
    ("LSTM", dict(num_layers=2, bidirectional=True), "TNC", False),
    ("LSTM", dict(), "NTC", True),
    ("GRU", dict(), "NTC", True),
    ("RNN", dict(activation="tanh"), "TNC", False),
])
def test_layer_matches_reference(cls, kw, layout, with_states):
    rng = np.random.RandomState(0)
    hidden, ndir = 5, 2 if kw.get("bidirectional") else 1
    x = rng.uniform(-1, 1, (3, 2, 6) if layout == "TNC" else (2, 3, 6))
    x = x.astype(np.float32)
    jnet = getattr(jmx.gluon.rnn, cls)(hidden, layout=layout, input_size=6,
                                       **kw)
    jnet.initialize(init=jmx.init.Zero())
    tnet = getattr(tmx.gluon.rnn, cls)(hidden, layout=layout, input_size=6,
                                       device="cpu", **kw)
    tnet.initialize()
    states = None
    if with_states:
        n = 2 if cls == "LSTM" else 1
        states = [rng.uniform(-1, 1, (kw.get("num_layers", 1) * ndir, 2,
                                      hidden)).astype(np.float32)
                  for _ in range(n)]
        shapes = [i["shape"] for i in tnet.state_info(2)]
        assert shapes == [s.shape for s in states]
    _compare(jnet, tnet, x, states,
             lambda net, xa, sa: net(xa) if sa is None else net(xa, sa))


def test_layer_defers_its_input_width():
    net = tmx.gluon.rnn.GRU(4, num_layers=2, device="cpu")
    net.initialize()
    out, states = net(tmx.nd.ones((3, 2, 7), ctx=CPU),
                      net.begin_state(2))
    assert out.shape == (3, 2, 4) and states[0].shape == (2, 2, 4)
    assert net.l0_i2h_weight.shape == (12, 7)
    assert net.l1_i2h_weight.shape == (12, 4)


def _cell_pair(kind, m, device):
    kw = {} if device is None else {"device": device}
    r = m.gluon.rnn
    if kind == "rnn":
        return r.RNNCell(6, activation="relu", input_size=6, **kw)
    if kind == "lstm":
        return r.LSTMCell(6, input_size=6, **kw)
    if kind == "gru":
        return r.GRUCell(6, input_size=6, **kw)
    if kind == "stack":
        cell = r.SequentialRNNCell()
        cell.add(r.LSTMCell(6, input_size=6, **kw))
        cell.add(r.DropoutCell(0.5))
        cell.add(r.ResidualCell(r.RNNCell(6, input_size=6, **kw)))
        return cell
    return r.BidirectionalCell(r.RNNCell(3, input_size=6, **kw),
                               r.RNNCell(4, input_size=6, **kw))


@pytest.mark.parametrize("kind,layout,merge,valid", [
    ("rnn", "NTC", True, True),
    ("lstm", "TNC", True, False),
    ("gru", "NTC", False, False),
    ("stack", "TNC", None, False),
    ("bidir", "NTC", True, False),
])
def test_cell_unroll_matches_reference(kind, layout, merge, valid):
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (3, 3, 6)).astype(np.float32)
    jcell = _cell_pair(kind, jmx, None)
    jcell.initialize(init=jmx.init.Zero())
    tcell = _cell_pair(kind, tmx, "cpu")
    tcell.initialize()
    lengths = np.array([3, 1, 2], np.float32)

    def fn(cell, xa, sa):
        vl = None
        if valid:
            vl = jmx.nd.array(lengths) if isinstance(cell, jmx.gluon.Block) \
                else tmx.nd.array(lengths, ctx=CPU)
        return cell.unroll(3, xa, layout=layout, merge_outputs=merge,
                           valid_length=vl)

    _compare(jcell, tcell, x, None, fn, train_mode=kind != "stack")
    if valid:
        out, _ = fn(tcell, tmx.nd.array(x, ctx=CPU), None)
        assert not out.asnumpy()[1, 1:].any()


def test_zoneout_cell():
    rng = np.random.RandomState(2)
    x = tmx.nd.array(rng.uniform(-1, 1, (3, 5, 4)).astype(np.float32),
                     ctx=CPU)
    base = tmx.gluon.rnn.LSTMCell(4, input_size=4, device="cpu")
    base.initialize()
    want, want_states = base.unroll(5, x)
    same = tmx.gluon.rnn.ZoneoutCell(base)
    got, got_states = same.unroll(5, x)
    assert np.array_equal(got.asnumpy(), want.asnumpy())
    for a, b in zip(got_states, want_states):
        assert np.array_equal(a.asnumpy(), b.asnumpy())
    tmx.random.seed(3)
    zoned = tmx.gluon.rnn.ZoneoutCell(base, zoneout_outputs=0.5)
    outs = zoned.unroll(5, x, merge_outputs=False)[0]
    new = base.unroll(5, x, merge_outputs=False)[0]
    kept = 0
    prev = np.zeros((3, 4), np.float32)
    for o, n in zip(outs, new):
        o, n = o.asnumpy(), n.asnumpy()
        assert np.all((o == n) | (o == prev))
        kept += int((o == n).sum())
        prev = o
    assert 0 < kept < 60


def test_embedding_matches_reference():
    rng = np.random.RandomState(3)
    w = rng.uniform(-1, 1, (10, 4)).astype(np.float32)
    idx = np.array([[0.0, 3.7, 9.0], [-1.0, 10.0, -11.0]], np.float32)
    jnet = jmx.gluon.nn.Embedding(10, 4)
    jnet.initialize()
    tnet = tmx.gluon.nn.Embedding(10, 4, device="cpu", sparse_grad=True)
    tnet.initialize()
    outs = []
    for mx, net, kw in ((jmx, jnet, {}), (tmx, tnet, {"ctx": CPU})):
        net.weight.set_data(mx.nd.array(w, **kw)) if mx is jmx else \
            net.collect_params()[net.prefix + "weight"].set_data(w)
        xa = mx.nd.array(idx, **kw)
        with mx.autograd.record():
            out = net(xa)
            loss = mx.nd.nansum(out * out)
        loss.backward()
        outs.append((out.asnumpy(), net.collect_params()[
            net.prefix + "weight"].grad().asnumpy()))
    (t_out, t_grad), (j_out, j_grad) = outs[1], outs[0]
    assert np.array_equal(np.isnan(t_out), np.isnan(j_out))
    assert np.isnan(t_out[1, 1:]).all() and not np.isnan(t_out[0]).any()
    assert np.array_equal(np.nan_to_num(t_out), np.nan_to_num(j_out))
    assert np.array_equal(t_grad, j_grad)


def test_sequential_and_lambdas_match_reference():
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (3, 5)).astype(np.float32)
    nets = []
    for mx, kw in ((jmx, {}), (tmx, {"device": "cpu"})):
        net = mx.gluon.nn.Sequential()
        net.add(mx.gluon.nn.Dense(4, in_units=5, **kw),
                mx.gluon.nn.HybridLambda("tanh"),
                mx.gluon.nn.Lambda("relu"))
        net.initialize()
        nets.append(net)
    assert len(nets[1]) == 3 and isinstance(nets[1][1:],
                                            tmx.gluon.nn.Sequential)
    _carry(*nets)
    outs = []
    for mx, net, kw in ((jmx, nets[0], {}), (tmx, nets[1], {"ctx": CPU})):
        with mx.autograd.record():
            out = net(mx.nd.array(x, **kw))
            (out * out).sum().backward()
        outs.append([out.asnumpy()] + _grads(net))
    for a, b in zip(outs[1], outs[0]):
        assert _rel(a, b) <= 1e-6


def test_begin_state_shapes_and_device():
    layer = tmx.gluon.rnn.LSTM(5, num_layers=2, bidirectional=True,
                               device="cpu")
    states = layer.begin_state(3)
    assert [s.shape for s in states] == [(4, 3, 5)] * 2
    assert all(s.context == CPU for s in states)
    stack = tmx.gluon.rnn.SequentialRNNCell()
    stack.add(tmx.gluon.rnn.GRUCell(2, device="cpu"))
    stack.add(tmx.gluon.rnn.DropoutCell(0.1))
    stack.add(tmx.gluon.rnn.LSTMCell(3, device="cpu"))
    assert [s.shape for s in stack.begin_state(4)] == [(4, 2), (4, 3),
                                                       (4, 3)]
    with pytest.raises(NotImplementedError, match="unroll"):
        tmx.gluon.rnn.BidirectionalCell(
            tmx.gluon.rnn.GRUCell(2, device="cpu"),
            tmx.gluon.rnn.GRUCell(2, device="cpu"))(
                torch.zeros(1, 2), [torch.zeros(1, 2)] * 2)
