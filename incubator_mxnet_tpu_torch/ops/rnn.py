"""The fused ``RNN`` op (port of ``incubator_mxnet_tpu/ops/rnn.py``):
``rnn_relu``, ``rnn_tanh``, ``lstm`` and ``gru`` over several layers, in
one direction or two.

The parameters come as the reference's flat vector: for each layer and
direction the input-to-hidden matrix ``Wx`` (G*H, in) and the
hidden-to-hidden ``Wh`` (G*H, H), all of them first, then the biases
``bx`` and ``bh`` (G*H,) in the same order.  The gates are i, f, g, o
for LSTM and r, z, n for GRU, which are PyTorch's orders too.
:func:`rnn` unpacks the vector into views (:func:`unpack_params`) and
runs PyTorch's fused recurrence, ``torch._VF.lstm``, ``gru``,
``rnn_tanh`` or ``rnn_relu`` with no dropout of its own: cuDNN's RNN on
the card, ATen's step loop on the CPU.  The reference runs one
``lax.scan`` per layer and direction, not a Pallas kernel, so this op
has no hand-written kernel.  cuDNN copies the views into its own packed
buffer on every call (and PyTorch warns once that the weights are not
one contiguous chunk); the gradients reach the vector through that copy.

Dropout between layers (training, ``p > 0``): the reference draws one
mask for each layer boundary; cuDNN's dropout cannot take the port's
generator, so each layer is then its own ``_VF`` call and the mask is
drawn between them by :func:`.nn.dropout` from the port's generator.

A begin state of batch 1 (the legacy ``FusedRNNCell``'s) is broadcast
to the data's batch, as the reference broadcasts it.  As in the
reference, ``projection_size``, ``lstm_state_clip_*`` and
``use_sequence_length``/``sequence_length`` are accepted and ignored
(ROADMAP Queue C).

:func:`rnn_plain` is the plain version: a step loop in torch ops that
mirrors the reference's ``rnn_cell_step`` and ``rnn_layer_scan``.  The
tests and ``chip_smoke.py`` hold :func:`rnn` to it; no path of the port
runs it otherwise.
"""
from __future__ import annotations

import torch

from .nn import _is_train, dropout
from .registry import register

__all__ = ["rnn_param_size", "unpack_params", "infer_input_size",
           "rnn_cell_step", "rnn_layer_scan", "rnn", "rnn_plain",
           "GATE_NAMES"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
#: the gate suffixes of the reference's unpacked weights
#: (``l0_i2h_f_weight``)
GATE_NAMES = {"rnn_relu": ("",), "rnn_tanh": ("",),
              "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}


def rnn_param_size(num_layers, input_size, state_size, mode="lstm",
                   bidirectional=False):
    """Length of the flat parameter vector."""
    ngates = _GATES[mode]
    ndir = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * ndir
        size += ndir * ngates * state_size * (in_sz + state_size + 2)
    return size


def infer_input_size(total, num_layers, state_size, mode, ndir):
    """The first layer's input width of a flat vector of ``total``
    entries."""
    gh = _GATES[mode] * state_size
    rest = sum(ndir * gh * (state_size * ndir + state_size + 2)
               for _ in range(1, num_layers))
    return int((total - rest) // (ndir * gh) - state_size - 2)


def unpack_params(params, num_layers, input_size, state_size, mode, ndir):
    """``[(wx, wh, bx, bh)]`` for each layer and direction in order (layer
    0 forward, layer 0 backward, layer 1, ...): views of ``params``."""
    gh = _GATES[mode] * state_size
    need = rnn_param_size(num_layers, input_size, state_size, mode,
                          ndir == 2)
    if params.numel() != need:
        raise ValueError("RNN: %d parameters for %d layers, input %d, "
                         "state %d, %s, %d direction(s): want %d"
                         % (params.numel(), num_layers, input_size,
                            state_size, mode, ndir, need))
    out = []
    offset = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * ndir
        for _ in range(ndir):
            wx = params[offset:offset + gh * in_sz].view(gh, in_sz)
            offset += gh * in_sz
            wh = params[offset:offset + gh * state_size].view(gh, state_size)
            offset += gh * state_size
            out.append([wx, wh])
    for entry in out:
        entry.append(params[offset:offset + gh])
        entry.append(params[offset + gh:offset + 2 * gh])
        offset += 2 * gh
    return [tuple(e) for e in out]


def _begin(state, batch, dtype):
    """A (L*D, b, H) state as (L*D, batch, H): b = 1 is broadcast."""
    s = state.to(dtype)
    if s.shape[1] != batch:
        s = s.expand(s.shape[0], batch, s.shape[2])
    return s.contiguous()


def _vf(mode, x, h0, c0, weights, num_layers, bidirectional, train):
    """One call of PyTorch's fused RNN, returning (out, h[, c])."""
    fn = getattr(torch._VF, mode)
    if mode == "lstm":
        return fn(x, (h0, c0), weights, True, num_layers, 0.0, train,
                  bidirectional, False)
    return fn(x, h0, weights, True, num_layers, 0.0, train, bidirectional,
              False)


def _meta_outputs(data, num_layers, state_size, mode, ndir, state_outputs):
    t, n = data.shape[0], data.shape[1]
    out = data.new_empty((t, n, state_size * ndir))
    if not state_outputs:
        return out
    h = data.new_empty((num_layers * ndir, n, state_size))
    return (out, h, h.clone()) if mode == "lstm" else (out, h)


def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, training=False, generator=None):
    """The fused RNN on ``data`` (T, N, C): the output (T, N, H * D), and
    with ``state_outputs`` the final h (and c for LSTM), (L * D, N, H).
    ``state``/``state_cell`` are (L * D, N or 1, H).  ``training`` and
    ``p > 0`` drop between layers, drawing from ``generator`` (default:
    the port's generator of the data's device)."""
    ndir = 2 if bidirectional else 1
    hidden, layers_n = int(state_size), int(num_layers)
    if data.device.type == "meta":
        return _meta_outputs(data, layers_n, hidden, mode, ndir,
                             state_outputs)
    batch = data.shape[1]
    params = parameters.to(data.dtype)
    weights = [t for layer in unpack_params(params, layers_n, data.shape[-1],
                                            hidden, mode, ndir)
               for t in layer]
    h0 = _begin(state, batch, data.dtype)
    c0 = _begin(state_cell, batch, data.dtype) \
        if mode == "lstm" and state_cell is not None else torch.zeros_like(h0)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (data, params, h0, c0))
    if training and p > 0 and layers_n > 1:
        x, finals = data, []
        for layer in range(layers_n):
            sl = slice(layer * ndir, (layer + 1) * ndir)
            res = _vf(mode, x, h0[sl], c0[sl],
                      weights[4 * ndir * layer:4 * ndir * (layer + 1)], 1,
                      ndir == 2, train)
            finals.append(res[1:])
            x = res[0]
            if layer < layers_n - 1:
                x = dropout(x, p, training=True, generator=generator)
        res = (x,) + tuple(torch.cat(f, 0) for f in zip(*finals))
    else:
        res = _vf(mode, data, h0, c0, weights, layers_n, ndir == 2, train)
    return tuple(res) if state_outputs else res[0]


def rnn_cell_step(mode, x, states, wx, wh, bx, bh):
    """One time step: ``(out, new_states)``, states ``(h,)`` or ``(h, c)``
    (the reference's ``rnn_cell_step``)."""
    h = states[0]
    hidden = wh.shape[-1]
    if mode == "gru":
        gx = x @ wx.T + bx
        gh = h @ wh.T + bh
        r = torch.sigmoid(gx[..., :hidden] + gh[..., :hidden])
        z = torch.sigmoid(gx[..., hidden:2 * hidden]
                          + gh[..., hidden:2 * hidden])
        n = torch.tanh(gx[..., 2 * hidden:] + r * gh[..., 2 * hidden:])
        h2 = (1 - z) * n + z * h
        return h2, (h2,)
    gates = x @ wx.T + h @ wh.T + bx + bh
    if mode == "rnn_relu":
        h2 = torch.relu(gates)
        return h2, (h2,)
    if mode == "rnn_tanh":
        h2 = torch.tanh(gates)
        return h2, (h2,)
    if mode == "lstm":
        i, f, g, o = gates.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2, (h2, c2)
    raise ValueError(mode)


def rnn_layer_scan(mode, data, h0, c0, wx, wh, bx, bh, reverse=False):
    """One layer and direction over time: ``(outs (T, N, H), final
    states)`` (the reference's ``rnn_layer_scan``)."""
    carry = (h0,) if mode != "lstm" else (h0, c0)
    steps = range(data.shape[0] - 1, -1, -1) if reverse \
        else range(data.shape[0])
    outs = [None] * data.shape[0]
    for t in steps:
        outs[t], carry = rnn_cell_step(mode, data[t], carry, wx, wh, bx, bh)
    return torch.stack(outs, 0), carry


def rnn_plain(data, parameters, state, state_cell=None, state_size=None,
              num_layers=1, mode="lstm", bidirectional=False, p=0.0,
              state_outputs=False, training=False, generator=None):
    """:func:`rnn` as the reference's step loop in torch ops (the same
    dropout draws between layers)."""
    ndir = 2 if bidirectional else 1
    hidden, layers_n = int(state_size), int(num_layers)
    batch = data.shape[1]
    layers = unpack_params(parameters.to(data.dtype), layers_n,
                           data.shape[-1], hidden, mode, ndir)
    h_state = _begin(state, batch, data.dtype)
    c_state = _begin(state_cell, batch, data.dtype) \
        if mode == "lstm" and state_cell is not None \
        else torch.zeros_like(h_state)
    x, h_finals, c_finals = data, [], []
    for layer in range(layers_n):
        outs_dirs = []
        for d in range(ndir):
            s = layer * ndir + d
            outs, carry = rnn_layer_scan(mode, x, h_state[s], c_state[s],
                                         *layers[s], reverse=d == 1)
            outs_dirs.append(outs)
            h_finals.append(carry[0])
            if mode == "lstm":
                c_finals.append(carry[1])
        x = outs_dirs[0] if ndir == 1 else torch.cat(outs_dirs, -1)
        if training and p > 0 and layer < layers_n - 1:
            x = dropout(x, p, training=True, generator=generator)
    if not state_outputs:
        return x
    h_out = torch.stack(h_finals, 0)
    if mode == "lstm":
        return x, h_out, torch.stack(c_finals, 0)
    return x, h_out


@register("RNN")
def _rnn_op(data, parameters, state, state_cell=None, state_size=None,
            num_layers=1, mode="lstm", bidirectional=False, p=0.0,
            state_outputs=False, projection_size=None,
            use_sequence_length=False, sequence_length=None,
            lstm_state_clip_min=None, lstm_state_clip_max=None,
            lstm_state_clip_nan=False):
    """The reference's registry form of :func:`rnn` (its PRNG ``key``
    aside); training mode is ``autograd.is_training()``."""
    return rnn(data, parameters, state, state_cell, state_size, num_layers,
               mode, bool(bidirectional), float(p), bool(state_outputs),
               training=_is_train())
