"""The port's fused ``RNN`` op (``ops/rnn.py``) against the JAX package's
``_rnn``.

- All four modes (``lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``), 1 and 2
  layers, one and two directions, f32, ``state_outputs``: the output,
  the final states and the gradients of the flat parameter vector, the
  input and the begin states (a random cotangent on every output), by
  both routes: ``rnn`` (``torch._VF``, ATen's loop on the CPU) and the
  plain step loop ``rnn_plain``.  Limits: outputs within 1e-5 and
  gradients within 1e-4 of each tensor's largest magnitude (measured:
  at most 3.3e-7, outputs and gradients alike).
- A batch-1 begin state (the legacy ``FusedRNNCell``'s) is broadcast as
  the reference broadcasts it, gradients summed back (same limits).
- Dropout between layers: ``p > 0`` outside training equals the
  reference; in training the ``_VF`` route equals the plain loop with
  the same generator seed (the same masks, 1e-5), and its masks keep
  the reference's statistics: a kept share of ``1 - p`` (within 0.02
  over 12k draws) and kept values scaled by exactly ``1 / (1 - p)``.
- The registered op: ``nd.RNN`` and its shapes on ``meta`` tensors; the
  reference's ignored arguments are accepted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import rnn as jrnn

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import rnn as trnn

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
T, N, C, H = 5, 3, 4, 6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(mode, layers, bidirectional, state_batch=N, seed=0):
    rng = np.random.RandomState(seed)
    ndir = 2 if bidirectional else 1
    size = jrnn.rnn_param_size(layers, C, H, mode, bidirectional)
    assert trnn.rnn_param_size(layers, C, H, mode, bidirectional) == size
    f32 = np.float32
    return dict(
        data=rng.uniform(-1, 1, (T, N, C)).astype(f32),
        parameters=rng.uniform(-0.5, 0.5, (size,)).astype(f32),
        state=rng.uniform(-1, 1, (layers * ndir, state_batch, H)).astype(f32),
        state_cell=rng.uniform(-1, 1, (layers * ndir, state_batch, H))
        .astype(f32))


def _reference(inp, cots, **attrs):
    """Outputs and gradients (wrt data, parameters, state, state_cell) of
    ``sum(out_i * cot_i)`` through the JAX ``_rnn``."""
    names = ("data", "parameters", "state", "state_cell")

    def f(args, cots):
        outs = jrnn._rnn(*args, state_outputs=True, **attrs)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    grads, outs = jax.jit(jax.grad(f, has_aux=True))(
        tuple(jnp.asarray(inp[n]) for n in names),
        [jnp.asarray(c) for c in cots])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(fn, inp, cots, **attrs):
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in inp.items()}
    outs = fn(ts["data"], ts["parameters"], ts["state"], ts["state_cell"],
              state_outputs=True, **attrs)
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    return [o.detach().numpy() for o in outs], \
        [np.zeros_like(inp[k]) if ts[k].grad is None else ts[k].grad.numpy()
         for k in ("data", "parameters", "state", "state_cell")]


def _cotangents(mode, layers, ndir, seed=1):
    rng = np.random.RandomState(seed)
    shapes = [(T, N, H * ndir), (layers * ndir, N, H)]
    if mode == "lstm":
        shapes.append((layers * ndir, N, H))
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _check(mode, layers, bidirectional, state_batch=N):
    inp = _inputs(mode, layers, bidirectional, state_batch)
    cots = _cotangents(mode, layers, 2 if bidirectional else 1)
    attrs = dict(state_size=H, num_layers=layers, mode=mode,
                 bidirectional=bidirectional)
    ref_outs, ref_grads = _reference(inp, cots, **attrs)
    if mode != "lstm":
        ref_grads[3] = np.zeros_like(inp["state_cell"])
    for fn in (trnn.rnn, trnn.rnn_plain):
        outs, grads = _port(fn, inp, cots, **attrs)
        assert len(outs) == len(ref_outs)
        for got, want in zip(outs, ref_outs):
            assert got.shape == want.shape
            assert _rel(got, want) <= OUT_TOL, (fn.__name__, _rel(got, want))
        for got, want in zip(grads, ref_grads):
            assert got.shape == want.shape
            assert _rel(got, want) <= GRAD_TOL, (fn.__name__,
                                                 _rel(got, want))


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bidirectional", [(1, False), (2, True)])
def test_rnn_matches_reference(mode, layers, bidirectional):
    _check(mode, layers, bidirectional)


@pytest.mark.parametrize("layers,bidirectional", [(2, False), (1, True)])
def test_lstm_other_depths_and_directions(layers, bidirectional):
    _check("lstm", layers, bidirectional)


def test_batch1_state_is_broadcast():
    _check("lstm", 2, True, state_batch=1)


def test_without_state_outputs_and_without_state_cell():
    inp = _inputs("lstm", 2, False)
    args = [torch.tensor(inp[k]) for k in ("data", "parameters", "state")]
    out = trnn.rnn(*args, state_size=H, num_layers=2, mode="lstm")
    ref = jrnn._rnn(*(jnp.asarray(inp[k]) for k in ("data", "parameters",
                                                       "state")),
                    state_size=H, num_layers=2, mode="lstm")
    assert isinstance(out, torch.Tensor)
    assert _rel(out.numpy(), ref) <= OUT_TOL


def test_dropout_outside_training_matches_reference():
    inp = _inputs("lstm", 2, True)
    cots = _cotangents("lstm", 2, 2)
    attrs = dict(state_size=H, num_layers=2, mode="lstm", bidirectional=True,
                 p=0.5)
    ref_outs, _ = _reference(inp, cots, **attrs)  # not training: no drop
    outs, _ = _port(trnn.rnn, inp, cots, training=False, **attrs)
    for got, want in zip(outs, ref_outs):
        assert _rel(got, want) <= OUT_TOL


def test_dropout_in_training_keeps_reference_statistics(monkeypatch):
    p = 0.25
    inp = _inputs("gru", 3, True)
    inp["data"] = np.random.RandomState(2).uniform(
        -1, 1, (40, 50, C)).astype(np.float32)
    inp["state"] = np.zeros((6, 50, H), np.float32)
    attrs = dict(state_size=H, num_layers=3, mode="gru", bidirectional=True,
                 p=p, state_outputs=True, training=True)
    args = [torch.tensor(inp[k]) for k in ("data", "parameters", "state")]
    seen = []
    real = trnn.dropout

    def recording(x, *a, **kw):
        y = real(x, *a, **kw)
        seen.append((x, y))
        return y

    monkeypatch.setattr(trnn, "dropout", recording)
    vf = trnn.rnn(*args, generator=torch.Generator().manual_seed(7), **attrs)
    plain = trnn.rnn_plain(*args, generator=torch.Generator().manual_seed(7),
                           **attrs)
    for got, want in zip(vf, plain):
        assert _rel(got.numpy(), want.numpy()) <= OUT_TOL
    assert len(seen) == 4  # two layer boundaries, each route
    for x, y in seen[:2]:
        kept = y != 0
        share = float(kept.float().mean())
        assert abs(share - (1 - p)) <= 0.02, share
        assert torch.equal(y[kept], x[kept] / (1 - p))
    untrained = trnn.rnn(*args, **dict(attrs, training=False))
    assert _rel(vf[0].numpy(), untrained[0].numpy()) > 1e-2


def test_registered_op_and_meta_shapes():
    inp = _inputs("lstm", 2, True)
    cpu = tmx.cpu()
    nds = [tmx.nd.array(inp[k], ctx=cpu) for k in ("data", "parameters",
                                                   "state", "state_cell")]
    out, h, c = tmx.nd.RNN(*nds, state_size=H, num_layers=2, mode="lstm",
                           bidirectional=True, state_outputs=True,
                           projection_size=None, lstm_state_clip_min=-1.0,
                           use_sequence_length=False)
    want = trnn.rnn(*(n.astorch() for n in nds), state_size=H, num_layers=2,
                    mode="lstm", bidirectional=True, state_outputs=True)
    for got, w in zip((out, h, c), want):
        assert torch.equal(got.astorch(), w)
    op = tmx.ops.registry.get_op("RNN")
    metas = op.infer([torch.empty(s.shape, device="meta") for s in nds],
                     state_size=H, num_layers=2, mode="lstm",
                     bidirectional=True, state_outputs=True)
    assert [tuple(m.shape) for m in metas] == [(T, N, 2 * H), (4, N, H),
                                               (4, N, H)]
    with pytest.raises(ValueError, match="want"):
        trnn.rnn(nds[0].astorch(), nds[1].astorch()[1:], nds[2].astorch(),
                 state_size=H, num_layers=2, mode="lstm", bidirectional=True)
