"""``mx.gluon.contrib.rnn`` (port of
``incubator_mxnet_tpu/gluon/contrib/rnn/__init__.py``):
``VariationalDropoutCell``, ``LSTMPCell`` and the convolutional cells
``Conv1D``/``2D``/``3D`` ``RNNCell``/``LSTMCell``/``GRUCell``.

Each cell's ``hybrid_forward`` is the reference's (the registry ops, in
its order): the tensor body and the symbolic one.  Input widths left at 0
are resolved from the first input (``Deferred``).
``VariationalDropoutCell`` draws one mask for the inputs, the first
state and the outputs each, kept until ``reset()`` (its masks come from
the port's generator); it composes on symbols only when every rate is 0,
as the reference, whose masks are ``nd.bernoulli`` draws.
"""
from __future__ import annotations

from .... import context
from ...block import Deferred
from ...rnn.rnn_cell import RecurrentCell, _bernoulli

__all__ = ["VariationalDropoutCell", "LSTMPCell", "Conv1DRNNCell",
           "Conv2DRNNCell", "Conv3DRNNCell", "Conv1DLSTMCell",
           "Conv2DLSTMCell", "Conv3DLSTMCell", "Conv1DGRUCell",
           "Conv2DGRUCell", "Conv3DGRUCell"]


class VariationalDropoutCell(RecurrentCell):
    """Variational dropout around ``base_cell``: one inverted-dropout
    mask a sequence for the inputs (``drop_inputs``), the first state
    (``drop_states``) and the outputs (``drop_outputs``), in every mode."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, **kwargs):
        super().__init__(**kwargs)
        self.register_child(base_cell, "base_cell")
        self._di, self._ds, self._do = (float(drop_inputs),
                                        float(drop_states),
                                        float(drop_outputs))
        self._masks = {}

    def reset(self):
        super().reset()
        self._masks = {}

    def state_info(self, batch_size=0):
        return self._children["base_cell"].state_info(batch_size)

    def _mask(self, name, p, like):
        if name not in self._masks:
            self._masks[name] = _bernoulli(1.0 - p, like) / (1.0 - p)
        return self._masks[name]

    def forward(self, x, states):
        if self._di > 0:
            x = x * self._mask("in", self._di, x)
        if self._ds > 0:
            states = list(states)
            states[0] = states[0] * self._mask("state", self._ds, states[0])
        out, new_states = self._children["base_cell"](x, states)
        if self._do > 0:
            out = out * self._mask("out", self._do, out)
        return out, new_states

    def hybrid_forward(self, F, x, states):  # noqa: N803
        if max(self._di, self._ds, self._do) > 0:
            raise NotImplementedError(
                "VariationalDropoutCell draws its masks eagerly: it composes "
                "on symbols only with every rate 0")
        return self._children["base_cell"](x, states)


class LSTMPCell(Deferred, RecurrentCell):
    """LSTM with a projection of the hidden state: ``h = (o * tanh(c)) @
    h2r_weight.T``, so the recurrent state is ``projection_size`` wide
    while the cell is ``hidden_size`` wide.  States ``[h, c]``."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._hidden_size = int(hidden_size)
        self._projection_size = int(projection_size)
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _infer_shapes(self, x):
        return {"i2h_weight": (4 * self._hidden_size, x.shape[-1])}

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       h2r_weight, i2h_bias, h2h_bias):
        nh = self._hidden_size
        h, c = states
        gates = (F.FullyConnected(x, i2h_weight, i2h_bias,
                                  num_hidden=4 * nh)
                 + F.FullyConnected(h, h2h_weight, h2h_bias,
                                    num_hidden=4 * nh))
        i = F.sigmoid(F.slice_axis(gates, axis=-1, begin=0, end=nh))
        f = F.sigmoid(F.slice_axis(gates, axis=-1, begin=nh, end=2 * nh))
        g = F.tanh(F.slice_axis(gates, axis=-1, begin=2 * nh, end=3 * nh))
        o = F.sigmoid(F.slice_axis(gates, axis=-1, begin=3 * nh,
                                   end=4 * nh))
        c_next = f * c + i * g
        h_next = F.FullyConnected(o * F.tanh(c_next), h2r_weight, None,
                                  num_hidden=self._projection_size,
                                  no_bias=True)
        return h_next, [h_next, c_next]


class _ConvCellBase(Deferred, RecurrentCell):
    """The convolutional cells' parameters and convolutions: i2h and h2h
    are convolutions over the spatial axes (h2h's kernel odd, padded to
    keep the state's shape); the gates combine as in the dense cells.
    ``input_shape`` is (C_in, *spatial), C_in 0 to defer it."""

    _nstates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 ngates, ndim, i2h_pad=None, conv_layout="NCHW",
                 activation="tanh", device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)

        def _tup(v, what):
            if isinstance(v, int):
                return (v,) * ndim
            v = tuple(int(d) for d in v)
            if len(v) != ndim:
                raise ValueError("%s must be an int or a %d-tuple, got %r"
                                 % (what, ndim, v))
            return v

        self._kernel = _tup(i2h_kernel, "i2h_kernel")
        self._h2h_kernel = _tup(h2h_kernel, "h2h_kernel")
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    "h2h kernel dims must be odd so state shape is "
                    "preserved; got %r" % (self._h2h_kernel,))
        self._i2h_pad = _tup(i2h_pad, "i2h_pad") if i2h_pad is not None \
            else tuple(k // 2 for k in self._kernel)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        self._channels = int(hidden_channels)
        self._input_shape = tuple(input_shape)
        self._ngates = ngates
        self._activation = activation
        gc = ngates * self._channels
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(gc, self._input_shape[0]) + self._kernel,
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(gc, self._channels) + self._h2h_kernel,
                allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(gc,), init="zeros",
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(gc,), init="zeros",
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        spatial = self._input_shape[1:]
        shape = (batch_size, self._channels) + spatial
        return [{"shape": shape,
                 "__layout__": "NC" + "DHW"[-len(spatial):]}] * self._nstates

    def _infer_shapes(self, x):
        return {"i2h_weight": (self._ngates * self._channels,
                               x.shape[1]) + self._kernel}

    def _convs(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,  # noqa: N803
               h2h_bias):
        i2h = F.Convolution(x, i2h_weight, i2h_bias, kernel=self._kernel,
                            num_filter=self._ngates * self._channels,
                            pad=self._i2h_pad)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            num_filter=self._ngates * self._channels,
                            pad=self._h2h_pad)
        return i2h, h2h

    @staticmethod
    def _split(F, t, k, channels):  # noqa: N803
        return F.slice_axis(t, axis=1, begin=k * channels,
                            end=(k + 1) * channels)


class _ConvRNNCell(_ConvCellBase):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 ndim, **kwargs):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, ngates=1, ndim=ndim, **kwargs)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, x, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class _ConvLSTMCell(_ConvCellBase):
    _nstates = 2

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 ndim, **kwargs):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, ngates=4, ndim=ndim, **kwargs)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       i2h_bias, h2h_bias):
        h, c = states
        i2h, h2h = self._convs(F, x, h, i2h_weight, h2h_weight, i2h_bias,
                               h2h_bias)
        gates = i2h + h2h
        ch = self._channels
        i = F.sigmoid(self._split(F, gates, 0, ch))
        f = F.sigmoid(self._split(F, gates, 1, ch))
        g = F.Activation(self._split(F, gates, 2, ch),
                         act_type=self._activation)
        o = F.sigmoid(self._split(F, gates, 3, ch))
        c_next = f * c + i * g
        h_next = o * F.Activation(c_next, act_type=self._activation)
        return h_next, [h_next, c_next]


class _ConvGRUCell(_ConvCellBase):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 ndim, **kwargs):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, ngates=3, ndim=ndim, **kwargs)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,  # noqa: N803
                       i2h_bias, h2h_bias):
        h = states[0]
        i2h, h2h = self._convs(F, x, h, i2h_weight, h2h_weight, i2h_bias,
                               h2h_bias)
        ch = self._channels
        r = F.sigmoid(self._split(F, i2h, 0, ch)
                      + self._split(F, h2h, 0, ch))
        z = F.sigmoid(self._split(F, i2h, 1, ch)
                      + self._split(F, h2h, 1, ch))
        # the reset gate scales the recurrent part of the candidate only
        n = F.Activation(self._split(F, i2h, 2, ch)
                         + r * self._split(F, h2h, 2, ch),
                         act_type=self._activation)
        h_next = (1.0 - z) * n + z * h
        return h_next, [h_next]


def _mk(cls, ndim, name, doc):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, **kwargs):  # noqa: N807
        cls.__init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, ndim=ndim, **kwargs)
    return type(name, (cls,), {"__init__": __init__, "__doc__": doc})


Conv1DRNNCell = _mk(_ConvRNNCell, 1, "Conv1DRNNCell",
                    "1D convolutional RNN cell")
Conv2DRNNCell = _mk(_ConvRNNCell, 2, "Conv2DRNNCell",
                    "2D convolutional RNN cell")
Conv3DRNNCell = _mk(_ConvRNNCell, 3, "Conv3DRNNCell",
                    "3D convolutional RNN cell")
Conv1DLSTMCell = _mk(_ConvLSTMCell, 1, "Conv1DLSTMCell",
                     "1D convolutional LSTM cell (Shi et al. 2015)")
Conv2DLSTMCell = _mk(_ConvLSTMCell, 2, "Conv2DLSTMCell",
                     "2D convolutional LSTM cell (Shi et al. 2015)")
Conv3DLSTMCell = _mk(_ConvLSTMCell, 3, "Conv3DLSTMCell",
                     "3D convolutional LSTM cell (Shi et al. 2015)")
Conv1DGRUCell = _mk(_ConvGRUCell, 1, "Conv1DGRUCell",
                    "1D convolutional GRU cell")
Conv2DGRUCell = _mk(_ConvGRUCell, 2, "Conv2DGRUCell",
                    "2D convolutional GRU cell")
Conv3DGRUCell = _mk(_ConvGRUCell, 3, "Conv3DGRUCell",
                    "3D convolutional GRU cell")
