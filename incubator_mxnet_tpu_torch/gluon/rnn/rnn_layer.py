"""Gluon recurrent layers (port of
``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and
``GRU`` over the fused ``RNN`` op (:mod:`...ops.rnn`).

Each layer holds the reference's parameters by name (``l0_i2h_weight``,
``l0_h2h_weight``, ``l0_i2h_bias``, ``l0_h2h_bias``, then ``r0_...`` for
the backward direction, layer by layer) and concatenates them into the
op's flat vector at every forward, as the reference's ``_flat_params``
does, so the gradients reach each parameter through the concatenation.
The first layer's input width may be left at 0: it is taken from the
first input (``gluon.block.Deferred``).  ``layout`` is ``"TNC"`` or
``"NTC"``; called without states a layer starts from zeros and returns
the output only, called with states it returns ``(output, states)``.
"""
from __future__ import annotations

import torch

from ... import context
from ...ops import rnn as rnn_ops
from ..block import Deferred, HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(Deferred, HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", device=None, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be 'TNC' or 'NTC', got %r"
                             % (layout,))
        self._device = context.resolve(device)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        gh = rnn_ops._GATES[mode] * hidden_size
        with self.name_scope():
            for i in range(num_layers):
                in_sz = input_size if i == 0 else hidden_size * self._dir
                for d in "lr"[:self._dir]:
                    for kind, shape, init in (
                            ("i2h_weight", (gh, in_sz),
                             i2h_weight_initializer),
                            ("h2h_weight", (gh, hidden_size),
                             h2h_weight_initializer),
                            ("i2h_bias", (gh,), i2h_bias_initializer),
                            ("h2h_bias", (gh,), h2h_bias_initializer)):
                        name = "%s%d_%s" % (d, i, kind)
                        setattr(self, name, self.params.get(
                            name, shape=shape, init=init,
                            allow_deferred_init=True))

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}] * n

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``func`` another ``nd`` factory), on
        ``ctx`` (default: the layer's device)."""
        from ... import ndarray as nd

        func = func or nd.zeros
        kwargs.setdefault("ctx", self.l0_h2h_weight.device)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _infer_shapes(self, x):
        gh = rnn_ops._GATES[self._mode] * self._hidden_size
        return {"%s0_i2h_weight" % d: (gh, x.shape[-1])
                for d in "lr"[:self._dir]}

    def _flat_params(self):
        """The parameters as the fused op's flat vector: every layer's and
        direction's weights, then every bias."""
        names = [("%s%d_" % (d, i)) for i in range(self._num_layers)
                 for d in "lr"[:self._dir]]
        weights = [getattr(self, p + k).reshape(-1) for p in names
                   for k in ("i2h_weight", "h2h_weight")]
        biases = [getattr(self, p + k) for p in names
                  for k in ("i2h_bias", "h2h_bias")]
        return torch.cat(weights + biases)

    def forward(self, x, states=None):
        ret_states = states is not None
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        if states is None:
            states = [torch.zeros(info["shape"], dtype=x.dtype,
                                  device=x.device)
                      for info in self.state_info(x.shape[1])]
        res = rnn_ops.rnn(
            x, self._flat_params(), states[0],
            states[1] if self._mode == "lstm" else None, self._hidden_size,
            self._num_layers, self._mode, self._dir == 2, self._dropout,
            state_outputs=True, training=self.training)
        out = res[0].transpose(0, 1) if self._layout == "NTC" else res[0]
        if ret_states:
            return out, list(res[1:])
        return out


class RNN(_RNNLayer):
    """Elman RNN, ``activation`` ``"relu"`` or ``"tanh"``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "rnn_" + activation,
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
