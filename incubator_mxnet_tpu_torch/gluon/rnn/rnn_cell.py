"""Gluon recurrent cells (port of
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py``): ``RNNCell``,
``LSTMCell``, ``GRUCell``, ``SequentialRNNCell``, ``DropoutCell``,
``BidirectionalCell``, ``ResidualCell`` and ``ZoneoutCell``, with
``unroll``.

A cell is called one step at a time, ``cell(x, states) -> (out,
new_states)``, on tensors or on NDArrays (recorded on the port's
autograd, as a ``HybridBlock``).  ``unroll(length, inputs, ...)`` steps
it over the time axis of ``layout`` (``"NTC"`` or ``"TNC"``), from zeros
unless given begin states; it returns the outputs stacked on that axis
(a list with ``merge_outputs=False``) and the final states.  With
``valid_length`` the outputs past each sequence's length are zeros.  As
in the reference, ``ZoneoutCell`` draws its masks in every mode (from the
port's generator), and ``BidirectionalCell`` runs only by ``unroll``.

On symbols a step composes a graph for ``RNNCell``, ``LSTMCell`` and
``GRUCell``, and for ``SequentialRNNCell``, ``ResidualCell`` and
``DropoutCell`` at rate 0 over such cells (their children compose in
turn), as the reference's do; ``ZoneoutCell``, ``DropoutCell`` at a
nonzero rate and ``unroll`` raise there, as the reference's do.
"""
from __future__ import annotations

import torch

from ... import context
from ... import random as _random
from ...ops import nn as ops
from ..block import Deferred, HybridBlock, _is_nd

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "BidirectionalCell",
           "ResidualCell", "ZoneoutCell"]


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.reset()

    def _alias(self):
        return "rnn_cell"

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``func`` another ``nd`` factory), on
        ``ctx`` (default: the device of the cell's parameters)."""
        from ... import ndarray as nd

        func = func or nd.zeros
        infos = self.state_info(batch_size)
        if infos:
            kwargs.setdefault("ctx", self._default_ctx())
        states = []
        for info in infos:
            self._init_counter += 1
            states.append(func(info["shape"], **kwargs))
        return states

    def _default_ctx(self):
        tensors = list(self.parameters())
        return tensors[0].device if tensors else context.resolve(None)

    def _zero_states(self, batch, like):
        return [torch.zeros(info["shape"], dtype=like.dtype,
                            device=like.device)
                for info in self.state_info(batch)]

    def __call__(self, x, states):
        self._counter += 1
        return super().__call__(x, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step over ``length`` steps of ``inputs``: ``(outputs, states)``
        (see the module docstring)."""
        args = (length, inputs, begin_state, layout, merge_outputs,
                valid_length)
        if _is_nd((inputs, begin_state, valid_length)):
            return self._on_tensors(self._unroll, args, {})
        return self._unroll(*args)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = begin_state if begin_state is not None \
            else self._zero_states(batch, inputs)
        outputs = []
        for i in range(length):
            out, states = self(inputs.select(axis, i), states)
            outputs.append(out)
        return _merge(outputs, states, axis, merge_outputs, valid_length)


def _merge(outputs, states, axis, merge_outputs, valid_length):
    if valid_length is not None:
        valid = valid_length.reshape(-1, 1)
        outputs = [torch.where(i < valid, o, torch.zeros_like(o))
                   for i, o in enumerate(outputs)]
    if merge_outputs is False:
        return outputs, states
    return torch.stack(outputs, axis), states


class _BaseCell(Deferred, RecurrentCell):
    def __init__(self, hidden_size, ngates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._ngates = ngates
        gh = ngates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(gh, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(gh, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(gh,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(gh,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def _infer_shapes(self, x):
        return {"i2h_weight": (self._ngates * self._hidden_size,
                               x.shape[-1])}

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]


class RNNCell(_BaseCell):
    """``act(W_x x + b_x + W_h h + b_h)``, ``activation`` ``"tanh"`` or
    any of ``Activation``'s."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseCell):
    """Gates i, f, c, o (input, forget, candidate, output)."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       i2h_bias, h2h_bias):
        nh = self._hidden_size
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=4 * nh)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * nh)
        gates = i2h + h2h
        in_gate = F.sigmoid(F.slice_axis(gates, axis=-1, begin=0, end=nh))
        forget = F.sigmoid(F.slice_axis(gates, axis=-1, begin=nh,
                                        end=2 * nh))
        in_trans = F.tanh(F.slice_axis(gates, axis=-1, begin=2 * nh,
                                       end=3 * nh))
        out_gate = F.sigmoid(F.slice_axis(gates, axis=-1, begin=3 * nh,
                                          end=4 * nh))
        c = forget * states[1] + in_gate * in_trans
        h = out_gate * F.tanh(c)
        return h, [h, c]


class GRUCell(_BaseCell):
    """Gates r, z, n (reset, update, candidate)."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       i2h_bias, h2h_bias):
        nh = self._hidden_size
        prev = states[0]
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=3 * nh)
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias, num_hidden=3 * nh)
        i2h_r = F.slice_axis(i2h, axis=-1, begin=0, end=nh)
        i2h_z = F.slice_axis(i2h, axis=-1, begin=nh, end=2 * nh)
        i2h_n = F.slice_axis(i2h, axis=-1, begin=2 * nh, end=3 * nh)
        h2h_r = F.slice_axis(h2h, axis=-1, begin=0, end=nh)
        h2h_z = F.slice_axis(h2h, axis=-1, begin=nh, end=2 * nh)
        h2h_n = F.slice_axis(h2h, axis=-1, begin=2 * nh, end=3 * nh)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset * h2h_n)
        h = (1.0 - update) * next_h_tmp + update * prev
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each with its slice
    of the states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._children.values()
                for info in cell.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        if self.state_info():
            kwargs.setdefault("ctx", self._default_ctx())
        return [s for cell in self._children.values()
                for s in cell.begin_state(batch_size, **kwargs)]

    def forward(self, x, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, new = cell(x, states[p:p + n])
            next_states.extend(new)
            p += n
        return x, next_states

    def hybrid_forward(self, F, x, states):  # noqa: N803
        return self.forward(x, states)

    def __len__(self):
        return len(self._children)


class DropoutCell(RecurrentCell):
    """Dropout of rate ``rate`` on the step's input, in training."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def forward(self, x, states):
        return ops.dropout(x, self._rate, training=self.training), states

    def hybrid_forward(self, F, x, states):  # noqa: N803
        if self._rate > 0:
            raise NotImplementedError(
                "DropoutCell composes on symbols only at rate 0 (the "
                "reference's dropout is an eager nd call)")
        return x, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, their
    outputs concatenated on the feature axis (``unroll`` only)."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self._children["l_cell"].state_info(batch_size)
                + self._children["r_cell"].state_info(batch_size))

    def __call__(self, x, states):
        raise NotImplementedError(
            "BidirectionalCell supports unroll() only (reference parity)")

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        l_cell = self._children["l_cell"]
        r_cell = self._children["r_cell"]
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self._zero_states(inputs.shape[layout.find("N")],
                                            inputs)
        nl = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(length, inputs, begin_state[:nl],
                                        layout, merge_outputs=True,
                                        valid_length=valid_length)
        r_out, r_states = r_cell.unroll(length, inputs.flip(axis),
                                        begin_state[nl:], layout,
                                        merge_outputs=True,
                                        valid_length=valid_length)
        out = torch.cat([l_out, r_out.flip(axis)], 2)
        return out, l_states + r_states


class ResidualCell(RecurrentCell):
    """The base cell's output plus its input."""

    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        self.register_child(base_cell, "base_cell")

    def state_info(self, batch_size=0):
        return self._children["base_cell"].state_info(batch_size)

    def forward(self, x, states):
        out, states = self._children["base_cell"](x, states)
        return out + x, states

    def hybrid_forward(self, F, x, states):  # noqa: N803
        return self.forward(x, states)


def _bernoulli(prob, like):
    gen = _random.generator(like.device)
    return (torch.rand(like.shape, generator=gen, device=like.device)
            < prob).to(like.dtype)


class ZoneoutCell(RecurrentCell):
    """Zoneout: where a mask drawn with probability ``zoneout_outputs``
    (``zoneout_states``) is off, keep the previous output (state).  As
    the reference, the masks are drawn in every mode and the state's
    keep and take masks are independent draws."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.register_child(base_cell, "base_cell")
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self._children["base_cell"].state_info(batch_size)

    def forward(self, x, states):
        out, new_states = self._children["base_cell"](x, states)
        if self._zo > 0:
            mask = _bernoulli(1 - self._zo, out)
            prev = self._prev_output if self._prev_output is not None \
                else torch.zeros_like(out)
            out = mask * out + (1 - mask) * prev
        self._prev_output = out
        if self._zs > 0:
            new_states = [_bernoulli(1 - self._zs, s) * s
                          + _bernoulli(self._zs, s) * olds
                          for s, olds in zip(new_states, states)]
        return out, new_states
