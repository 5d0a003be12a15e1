"""``mx.gluon.rnn``: recurrent layers over the fused ``RNN`` op and cells
with ``unroll`` (port of ``incubator_mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "BidirectionalCell",
           "ResidualCell", "ZoneoutCell"]
