"""``mx.rnn``: the legacy symbolic RNN cells, their checkpoint helpers and
the bucketed sentence iterator (port of ``incubator_mxnet_tpu/rnn``)."""
from .rnn_cell import (BaseRNNCell, RNNParams, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       ModifierCell, DropoutCell, ZoneoutCell, ResidualCell)
from .rnn import save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BaseRNNCell", "RNNParams", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint",
           "BucketSentenceIter", "encode_sentences"]
