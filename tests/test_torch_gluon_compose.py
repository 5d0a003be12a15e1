"""Blocks called on symbols: the port composes exactly where the JAX
package composes, and the graphs are equal node for node (the JSON, under
fresh block and symbol names on both sides).  Where the reference raises
(its body reads a symbol's shape, draws an eager mask or calls an ``nd``
op), the port raises too.

The cases are the losses, the recurrent cells (``SequentialRNNCell``,
``ResidualCell`` and ``DropoutCell`` at rate 0 over composing cells; the
others raise), the contrib layers and cells, and the norms, N-D
convolutions and pools, padding and activations of ``gluon.nn``.  A
trace, no compute.
"""
import json

import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.block import _BlockScope as _JScope

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context
from incubator_mxnet_tpu_torch.gluon.block import _BlockScope as _TScope


def _v(m, *names):
    return [m.sym.var(n) for n in names]


def _loss(name, n_inputs=2, **kw):
    return (lambda m: getattr(m.gluon.loss, name)(**kw),
            lambda b, m: b(*_v(m, "pred", "label", "third")[:n_inputs]))


def _step(states):
    def call(b, m):
        out, new = b(m.sym.var("x"), _v(m, *states))
        return m.sym.Group([out] + list(new))
    return call


def _seq(m):
    cell = m.gluon.rnn.SequentialRNNCell()
    cell.add(m.gluon.rnn.LSTMCell(6, input_size=4))
    cell.add(m.gluon.rnn.DropoutCell(0.0))
    cell.add(m.gluon.rnn.GRUCell(5, input_size=6))
    return cell


def _seq_residual(m):
    cell = m.gluon.rnn.SequentialRNNCell()
    cell.add(m.gluon.rnn.ResidualCell(m.gluon.rnn.LSTMCell(4, input_size=4)))
    cell.add(m.gluon.rnn.RNNCell(4, input_size=4, activation="relu"))
    return cell


def _concurrent(m, hybrid=True):
    cls = m.gluon.contrib.nn.HybridConcurrent if hybrid \
        else m.gluon.contrib.nn.Concurrent
    c = cls(axis=1)
    c.add(m.gluon.nn.Dense(3, in_units=5))
    c.add(m.gluon.contrib.nn.Identity())
    c.add(m.gluon.nn.Dense(2, in_units=5, activation="relu"))
    return c


def _unroll(m):
    return m.gluon.rnn.LSTMCell(4, input_size=3)


def _x(b, m):
    return b(m.sym.var("x"))


CASES = {
    # the losses: SoftmaxCrossEntropyLoss and KLDivLoss compose
    "softmax_ce": _loss("SoftmaxCrossEntropyLoss"),
    "softmax_ce_logits_axis": _loss("SoftmaxCrossEntropyLoss", axis=1,
                                    from_logits=True, weight=0.5,
                                    batch_axis=1),
    "softmax_ce_sample_weight": _loss("SoftmaxCrossEntropyLoss", 3),
    "softmax_ce_dense_label": _loss("SoftmaxCrossEntropyLoss",
                                    sparse_label=False),
    "kl_div": _loss("KLDivLoss"),
    "kl_div_softmax_weighted": _loss("KLDivLoss", 3, from_logits=False,
                                     weight=2.0),
    "l2": _loss("L2Loss"), "l1": _loss("L1Loss"),
    "sigmoid_bce": _loss("SigmoidBinaryCrossEntropyLoss"),
    "huber": _loss("HuberLoss"), "hinge": _loss("HingeLoss"),
    "squared_hinge": _loss("SquaredHingeLoss"),
    "logistic": _loss("LogisticLoss"),
    "triplet": _loss("TripletLoss", 3),
    "poisson_nll": _loss("PoissonNLLLoss"),
    "cosine_embedding": _loss("CosineEmbeddingLoss", 3),
    "ctc": _loss("CTCLoss"),
    # the recurrent cells
    "lstm_cell": (lambda m: m.gluon.rnn.LSTMCell(6, input_size=4),
                  _step(["h", "c"])),
    "gru_cell": (lambda m: m.gluon.rnn.GRUCell(6, input_size=4),
                 _step(["h"])),
    "rnn_cell": (lambda m: m.gluon.rnn.RNNCell(6, input_size=4),
                 _step(["h"])),
    "sequential_cell": (_seq, _step(["h0", "c0", "h1"])),
    "sequential_residual_cell": (_seq_residual, _step(["h0", "c0", "h1"])),
    "residual_cell": (lambda m: m.gluon.rnn.ResidualCell(
        m.gluon.rnn.GRUCell(4, input_size=4)), _step(["h"])),
    "dropout_cell_0": (lambda m: m.gluon.rnn.DropoutCell(0.0), _step([])),
    "dropout_cell_half": (lambda m: m.gluon.rnn.DropoutCell(0.5),
                          _step([])),
    "zoneout_cell": (lambda m: m.gluon.rnn.ZoneoutCell(
        m.gluon.rnn.LSTMCell(4, input_size=4), 0.2, 0.2), _step(["h", "c"])),
    "lstm_layer": (lambda m: m.gluon.rnn.LSTM(5, input_size=3),
                   lambda b, m: b(m.sym.var("x"))),
    "cell_unroll": (_unroll, lambda b, m: b.unroll(3, m.sym.var("x"))),
    # the contrib layers and cells
    "hybrid_concurrent": (_concurrent, _x),
    "concurrent": (lambda m: _concurrent(m, hybrid=False), _x),
    "identity": (lambda m: m.gluon.contrib.nn.Identity(), _x),
    "sparse_embedding": (lambda m: m.gluon.contrib.nn.SparseEmbedding(7, 3),
                         _x),
    "sync_batch_norm": (lambda m: m.gluon.contrib.nn.SyncBatchNorm(
        in_channels=4), _x),
    "pixel_shuffle_2d": (lambda m: m.gluon.contrib.nn.PixelShuffle2D(2), _x),
    "lstmp_cell": (lambda m: m.gluon.contrib.rnn.LSTMPCell(
        6, 3, input_size=4), _step(["h", "c"])),
    "conv2d_lstm_cell": (lambda m: m.gluon.contrib.rnn.Conv2DLSTMCell(
        (2, 5, 5), 3, 3, 3), _step(["h", "c"])),
    "conv1d_gru_cell": (lambda m: m.gluon.contrib.rnn.Conv1DGRUCell(
        (2, 7), 3, 3, 1), _step(["h"])),
    "variational_dropout_0": (
        lambda m: m.gluon.contrib.rnn.VariationalDropoutCell(
            m.gluon.rnn.LSTMCell(4, input_size=4)), _step(["h", "c"])),
    "variational_dropout_half": (
        lambda m: m.gluon.contrib.rnn.VariationalDropoutCell(
            m.gluon.rnn.LSTMCell(4, input_size=4), drop_inputs=0.5),
        _step(["h", "c"])),
    "deformable_convolution": (
        lambda m: m.gluon.contrib.cnn.DeformableConvolution(
            4, in_channels=3, num_deformable_group=1), _x),
}


def _layer(cls, **kw):
    return (lambda m: getattr(m.gluon.nn, cls)(**kw), _x)


# the norms, N-D convolutions and pools, padding and activations of
# gluon.nn: all compose in the reference (LeakyReLU's act types compose a
# ``<name>_gamma`` variable there, the op's optional input)
NN_LAYERS = {
    "instance_norm": _layer("InstanceNorm", in_channels=3),
    "layer_norm": _layer("LayerNorm", in_channels=4),
    "group_norm": _layer("GroupNorm", num_groups=2, in_channels=4),
    "conv1d": _layer("Conv1D", channels=4, kernel_size=3, in_channels=2),
    "conv3d": _layer("Conv3D", channels=4, kernel_size=3, strides=2,
                     in_channels=2),
    "conv1d_transpose": _layer("Conv1DTranspose", channels=4, kernel_size=3,
                               in_channels=2),
    "conv2d_transpose": _layer("Conv2DTranspose", channels=4, kernel_size=3,
                               strides=2, output_padding=1, in_channels=2,
                               activation="relu"),
    "conv3d_transpose": _layer("Conv3DTranspose", channels=4, kernel_size=3,
                               in_channels=2, use_bias=False),
    "max_pool1d": _layer("MaxPool1D", ceil_mode=True),
    "max_pool3d": _layer("MaxPool3D", strides=1, padding=1),
    "avg_pool1d": _layer("AvgPool1D", count_include_pad=False),
    "avg_pool3d": _layer("AvgPool3D"),
    "global_max_pool1d": _layer("GlobalMaxPool1D"),
    "global_max_pool3d": _layer("GlobalMaxPool3D"),
    "global_avg_pool1d": _layer("GlobalAvgPool1D"),
    "global_avg_pool3d": _layer("GlobalAvgPool3D"),
    "reflection_pad2d": _layer("ReflectionPad2D", padding=1),
    "leaky_relu": _layer("LeakyReLU", alpha=0.1),
    "prelu": _layer("PReLU"),
    "elu": _layer("ELU"),
    "selu": _layer("SELU"),
    "gelu": _layer("GELU"),
    "swish": _layer("Swish", beta=2.0),
}
CASES.update(NN_LAYERS)

#: where the reference composes
COMPOSES = {"softmax_ce", "softmax_ce_logits_axis", "softmax_ce_sample_weight",
            "kl_div", "kl_div_softmax_weighted", "lstm_cell", "gru_cell",
            "rnn_cell", "sequential_cell", "sequential_residual_cell",
            "residual_cell", "dropout_cell_0", "hybrid_concurrent",
            "identity", "sparse_embedding", "sync_batch_norm", "lstmp_cell",
            "conv2d_lstm_cell", "conv1d_gru_cell", "variational_dropout_0"} \
    | set(NN_LAYERS)


def _compose(mod, scope, build, call):
    scope._state.counter = {}
    with context.device_scope("cpu"):
        block = build(mod)
    with mod.name.NameManager():
        return call(block, mod)


@pytest.mark.parametrize("case", sorted(CASES))
def test_composes_where_the_reference_composes(case):
    build, call = CASES[case]
    try:
        want = _compose(jmx, _JScope, build, call)
    except Exception:  # noqa: BLE001  (any failure of the reference)
        want = None
    assert (want is not None) == (case in COMPOSES)
    if want is None:
        with pytest.raises(Exception):
            _compose(tmx, _TScope, build, call)
        return
    got = _compose(tmx, _TScope, build, call)
    jg, tg = json.loads(want.tojson()), json.loads(got.tojson())
    assert len(tg["nodes"]) == len(jg["nodes"])
    for i, (a, b) in enumerate(zip(jg["nodes"], tg["nodes"])):
        assert b == a, "node %d differs" % i
    assert tg["heads"] == jg["heads"]
    assert got.list_arguments() == want.list_arguments()
    assert got.list_outputs() == want.list_outputs()
