"""RNN checkpoint helpers (port of ``incubator_mxnet_tpu/rnn/rnn.py``; the
reference's ``python/mxnet/rnn/rnn.py``: save_rnn_checkpoint :28,
load_rnn_checkpoint :59, do_rnn_checkpoint :88).

Cells with fused/packed weights are unpacked before saving so checkpoints
are interchangeable between fused and unfused cells."""
from __future__ import annotations

from .. import model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _normalize_cells(cells):
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    return cells


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save checkpoint with cell weights unpacked (rnn.py:28)."""
    for cell in _normalize_cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch, ctx=None):
    """Load checkpoint (the arrays on ``ctx``, ``None`` the card) and
    re-pack cell weights (rnn.py:59)."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch, ctx)
    for cell in _normalize_cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback that saves unpacked checkpoints (rnn.py:88)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
