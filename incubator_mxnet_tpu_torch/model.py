"""Checkpoints of a symbolic model (port of
``incubator_mxnet_tpu/model.py``, ``python/mxnet/model.py``
``save_checkpoint``/``load_checkpoint``): ``prefix-symbol.json`` (the
reference's JSON) and ``prefix-%04d.params`` (the ``.params`` container,
``arg:``/``aux:`` keys), so a checkpoint written by either package loads
in the other.
"""
from __future__ import annotations

from .ndarray import load as nd_load
from .ndarray import save as nd_save

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd_save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays on
    ``ctx`` (``None``: the card)."""
    from . import symbol as sym_mod

    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd_load("%s-%04d.params" % (prefix, epoch), ctx).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
