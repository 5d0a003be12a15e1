"""Legacy symbolic RNN cells (port of
``incubator_mxnet_tpu/rnn/rnn_cell.py``; the reference's
``python/mxnet/rnn/rnn_cell.py``): ``RNNParams``, ``BaseRNNCell``,
``RNNCell``, ``LSTMCell``, ``GRUCell``, ``FusedRNNCell`` (with
``unfuse`` and the weights' pack/unpack), ``SequentialRNNCell``,
``BidirectionalCell``, ``ModifierCell``, ``DropoutCell``,
``ZoneoutCell`` and ``ResidualCell``.

Cells compose ``mx.sym`` graphs one time step at a time; ``unroll``
expands the recurrence into the graph, which the port's ``Executor``
walks eagerly.  ``FusedRNNCell`` is one ``RNN`` node (cuDNN's RNN on the
card).  Begin states are zeros symbols of batch 1, broadcast against the
data's batch where they are used (the fused op broadcasts them too), as
in the reference.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import symbol as sym_mod
from ..ndarray import NDArray
from ..ndarray import concat as nd_concat
from ..ops import rnn as rnn_ops
from ..symbol import Symbol

__all__ = ["BaseRNNCell", "RNNParams", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


def _tensor(v):
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


class RNNParams:
    """Container for cell parameter Symbols, shared by prefix
    (rnn_cell.py:60)."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._params = {}

    def get(self, name: str, **kwargs) -> Symbol:
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym_mod.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract symbolic RNN cell (rnn_cell.py:108)."""

    def __init__(self, prefix: str = "", params: Optional[RNNParams] = None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self) -> RNNParams:
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states as zeros symbols with batch dim 1 (broadcast at
        use sites) — rnn_cell.py:147."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        if func is None:
            func = sym_mod.zeros
        states = []
        for info in self.state_info:
            self._init_counter += 1
            state = func(shape=info["shape"], **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split packed gate weights into per-gate arrays
        (rnn_cell.py:172)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights` (rnn_cell.py:194)."""
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd_concat(*weight, dim=0)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd_concat(*bias, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the recurrence ``length`` steps into the symbolic graph
        (rnn_cell.py:217)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    # internal counters for unique op naming
    def _get_counter_name(self, suffix):
        self._counter += 1
        return "%st%d_%s" % (self._prefix, self._counter, suffix)


def _normalize_sequence(length, inputs, layout, merge,
                        in_layout=None):
    """Convert between a time-major list of (N,C) step symbols and one
    stacked Symbol (rnn_cell.py:54 _normalize_sequence)."""
    assert layout in ("NTC", "TNC"), "invalid layout %s" % layout
    axis = layout.find("T")
    if isinstance(inputs, Symbol):
        if merge is False:
            outputs = list(sym_mod.split(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=True))
            return outputs, axis
        return inputs, axis
    # list of step symbols
    if merge is None or merge is False:
        return list(inputs), axis
    stacked = sym_mod.stack(*inputs, axis=axis)
    return stacked, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: h' = act(W_x x + W_h h + b) (rnn_cell.py:338)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (1, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._get_counter_name("")
        i2h = sym_mod.FullyConnected(data=inputs, weight=self._iW,
                                     bias=self._iB,
                                     num_hidden=self._num_hidden,
                                     name="%si2h" % name)
        h2h = sym_mod.FullyConnected(data=states[0], weight=self._hW,
                                     bias=self._hB,
                                     num_hidden=self._num_hidden,
                                     name="%sh2h" % name)
        output = sym_mod.Activation(sym_mod.broadcast_add(i2h, h2h),
                                    act_type=self._activation,
                                    name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell with forget-gate bias (rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        from ..initializer import LSTMBias
        self._iW = self.params.get("i2h_weight")
        # forget_bias enters through bias *initialization*, not a runtime
        # add, so fused/unfused cells sharing raw weights match exactly
        # (rnn_cell.py:430 init=init.LSTMBias(forget_bias))
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (1, self._num_hidden), "__layout__": "NC"},
                {"shape": (1, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        name = self._get_counter_name("")
        i2h = sym_mod.FullyConnected(data=inputs, weight=self._iW,
                                     bias=self._iB,
                                     num_hidden=self._num_hidden * 4,
                                     name="%si2h" % name)
        h2h = sym_mod.FullyConnected(data=states[0], weight=self._hW,
                                     bias=self._hB,
                                     num_hidden=self._num_hidden * 4,
                                     name="%sh2h" % name)
        gates = sym_mod.broadcast_add(i2h, h2h)
        slices = list(sym_mod.SliceChannel(gates, num_outputs=4, axis=1,
                                           name="%sslice" % name))
        in_gate = sym_mod.Activation(slices[0], act_type="sigmoid")
        forget_gate = sym_mod.Activation(slices[1], act_type="sigmoid")
        in_transform = sym_mod.Activation(slices[2], act_type="tanh")
        out_gate = sym_mod.Activation(slices[3], act_type="sigmoid")
        next_c = sym_mod.broadcast_add(
            sym_mod.broadcast_mul(forget_gate, states[1]),
            in_gate * in_transform, name="%sstate" % name)
        next_h = out_gate * sym_mod.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (rnn_cell.py:470)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (1, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        name = self._get_counter_name("")
        prev_h = states[0]
        i2h = sym_mod.FullyConnected(data=inputs, weight=self._iW,
                                     bias=self._iB,
                                     num_hidden=self._num_hidden * 3,
                                     name="%si2h" % name)
        h2h = sym_mod.FullyConnected(data=prev_h, weight=self._hW,
                                     bias=self._hB,
                                     num_hidden=self._num_hidden * 3,
                                     name="%sh2h" % name)
        i2h_r, i2h_z, i2h_o = list(sym_mod.SliceChannel(
            i2h, num_outputs=3, axis=1))
        h2h_r, h2h_z, h2h_o = list(sym_mod.SliceChannel(
            h2h, num_outputs=3, axis=1))
        reset = sym_mod.Activation(sym_mod.broadcast_add(i2h_r, h2h_r),
                                   act_type="sigmoid")
        update = sym_mod.Activation(sym_mod.broadcast_add(i2h_z, h2h_z),
                                    act_type="sigmoid")
        next_h_tmp = sym_mod.Activation(
            sym_mod.broadcast_add(i2h_o, reset * h2h_o), act_type="tanh")
        next_h = sym_mod.broadcast_add(
            (1.0 - update) * next_h_tmp, sym_mod.broadcast_mul(update, prev_h),
            name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer (bi)RNN: one ``RNN`` node over the packed
    vector ``<prefix>parameters`` (rnn_cell.py:536; the fused op,
    :mod:`..ops.rnn`)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")

    @property
    def _num_directions(self):
        return 2 if self._bidirectional else 1

    @property
    def state_info(self):
        n = self._num_layers * self._num_directions
        info = [{"shape": (n, 1, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (n, 1, self._num_hidden),
                         "__layout__": "LNC"})
        return info

    @property
    def _gate_names(self):
        return rnn_ops.GATE_NAMES[self._mode]

    def unpack_weights(self, args):
        """The packed vector ``<prefix>parameters`` as each layer's and
        direction's ``i2h``/``h2h`` weights and biases
        (``<prefix>l0_i2h_weight``, ``<prefix>r1_h2h_bias``), copies on
        the vector's device (rnn_cell.py:616)."""
        args = args.copy()
        arr = _tensor(args.pop("%sparameters" % self._prefix))
        ndir = self._num_directions
        input_size = rnn_ops.infer_input_size(
            arr.numel(), self._num_layers, self._num_hidden, self._mode, ndir)
        layers = rnn_ops.unpack_params(arr, self._num_layers, input_size,
                                       self._num_hidden, self._mode, ndir)
        for i, (wx, wh, bx, bh) in enumerate(layers):
            p = "%s%s%d_" % (self._prefix, "lr"[i % ndir], i // ndir)
            for name, t in (("i2h_weight", wx), ("h2h_weight", wh),
                            ("i2h_bias", bx), ("h2h_bias", bh)):
                args[p + name] = NDArray(t.detach().clone())
        return args

    def pack_weights(self, args):
        """Each layer's and direction's arrays as the packed vector
        (rnn_cell.py:650)."""
        args = args.copy()
        ndir = self._num_directions
        weights, biases = [], []
        for layer in range(self._num_layers):
            for d in range(ndir):
                p = "%s%s%d_" % (self._prefix, "lr"[d], layer)
                weights += [_tensor(args.pop(p + "i2h_weight")).reshape(-1),
                            _tensor(args.pop(p + "h2h_weight")).reshape(-1)]
                biases += [_tensor(args.pop(p + "i2h_bias")).reshape(-1),
                           _tensor(args.pop(p + "h2h_bias")).reshape(-1)]
        args["%sparameters" % self._prefix] = NDArray(
            torch.cat(weights + biases).detach())
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped one step at a time; use unroll "
            "(rnn_cell.py:688)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC → TNC for the fused op
            inputs = sym_mod.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        kwargs = dict(state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      mode=self._mode,
                      bidirectional=self._bidirectional,
                      p=self._dropout,
                      state_outputs=self._get_next_state,
                      name="%srnn" % self._prefix)
        if self._mode == "lstm":
            rnn = sym_mod.RNN(data=inputs, parameters=self._parameter,
                              state=states[0], state_cell=states[1], **kwargs)
        else:
            rnn = sym_mod.RNN(data=inputs, parameters=self._parameter,
                              state=states[0], **kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outs = list(rnn)
            outputs, states = outs[0], [outs[1], outs[2]]
        else:
            outs = list(rnn)
            outputs, states = outs[0], [outs[1]]
        if axis == 1:
            outputs = sym_mod.swapaxes(outputs, dim1=0, dim2=1)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def unfuse(self):
        """Equivalent SequentialRNNCell of unfused cells
        (rnn_cell.py:750)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p,
                                       forget_bias=self._forget_bias),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (
                                          self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence each step (rnn_cell.py:878)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells: List[BaseRNNCell] = []
        self._override_cell_params = params is not None

    def add(self, cell: BaseRNNCell):
        """Append a cell; with a shared ``params`` container, child cells
        adopt (and contribute to) the container's symbols
        (rnn_cell.py:891)."""
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child cells, "\
                "not both."
            cell.params._params.update(self._params._params)
        self._params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states

    def __len__(self):
        return len(self._cells)


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


class BidirectionalCell(BaseRNNCell):
    """Runs l_cell forward and r_cell backward over the sequence
    (rnn_cell.py:998)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cells cannot be stepped; use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [sym_mod.concat(l_o, r_o, dim=1,
                                  name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (rnn_cell.py:956)."""

    def __init__(self, base_cell: BaseRNNCell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout on the step output (rnn_cell.py:935)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym_mod.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization: randomly keep previous states
    (rnn_cell.py:1000)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return sym_mod.Dropout(sym_mod.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else sym_mod.zeros_like(next_output)
        output = (sym_mod.where(mask(p_outputs, next_output), next_output,
                                prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([sym_mod.where(mask(p_states, new_s), new_s,
                                 sym_mod.broadcast_mul(
                                     sym_mod.ones_like(new_s), old_s))
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell output (rnn_cell.py:1061)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = sym_mod.elemwise_add(output, inputs)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        if isinstance(outputs, Symbol):
            stacked_inputs, _ = _normalize_sequence(length, inputs, layout,
                                                    True)
            outputs = sym_mod.elemwise_add(outputs, stacked_inputs)
        else:
            ins, _ = _normalize_sequence(length, inputs, layout, False)
            outputs = [sym_mod.elemwise_add(o, i)
                       for o, i in zip(outputs, ins)]
        return outputs, states
