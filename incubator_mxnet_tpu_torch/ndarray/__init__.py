"""``mx.nd``: the imperative operator namespace (port of
``incubator_mxnet_tpu/ndarray/__init__.py``).

A module ``__getattr__`` resolves any registered op name to an eager
wrapper, as the reference code-generates its wrappers: ``nd.<op>(...)``
works for every op of :mod:`..ops.math`, :mod:`..ops.tensor`,
:mod:`..random` and the ``_contrib_flash_attention`` op of
:mod:`.contrib`; ``mx.nd.linalg`` holds the ``la_op`` family.
"""
from __future__ import annotations

import inspect
import sys

from ..ops import math as _math  # noqa: F401  (registers the ops)
from ..ops import registry as _reg
from ..ops import tensor as _tensor  # noqa: F401
from .. import random as _random  # noqa: F401
from .ndarray import (NDArray, arange, array, concat, empty, full,
                      onehot_encode, ones, stack, waitall, zeros)
from . import contrib, linalg, random, utils
from .utils import load, save

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "stack", "waitall", "save", "load", "random", "contrib",
           "linalg", "onehot_encode", "utils"]

# optional tensor inputs the reference names in its signatures
_OPTIONAL_INPUTS = ("bias", "gamma", "state_cell", "sequence_length",
                    "label_lengths",
                    "data_lengths", "r1_r2", "min_bias", "max_bias",
                    "valid_length", "max_time")


def _input_names(op):
    """Positional parameters without a default are tensor inputs
    (``FListInputNames``); None for a variadic op."""
    names = []
    for p in inspect.signature(op.fn).parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return None
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            if p.default is inspect.Parameter.empty \
                    or p.name in _OPTIONAL_INPUTS:
                names.append(p.name)
    return names


def _attr_names(op, n_inputs):
    """Keyword parameters after the tensor inputs, in signature order."""
    names = [p.name for p in inspect.signature(op.fn).parameters.values()
             if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    return names[n_inputs:]


def _make_wrapper(name, op):
    in_names = _input_names(op)
    attr_names = _attr_names(op, len(in_names)) if in_names is not None \
        else []

    def wrapper(*args, out=None, name=None, **kwargs):  # noqa: A002
        inputs = list(args)
        if in_names is not None:
            # positional arguments past the tensor inputs are attributes
            # (the reference's convention: nd.swapaxes(x, 0, 1))
            if len(inputs) > len(in_names):
                extras = inputs[len(in_names):]
                inputs = inputs[:len(in_names)]
                for attr, val in zip(attr_names, extras):
                    kwargs.setdefault(attr, val)
            for n in in_names[len(inputs):]:
                if n not in kwargs:
                    break
                inputs.append(kwargs.pop(n))
        if op.num_inputs not in (0, None):
            kwargs.pop("ctx", None)
        return _reg.invoke(op.name, inputs, out=out, **kwargs)

    wrapper.__name__ = name
    wrapper.__doc__ = op.doc
    return wrapper


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        op = _reg.get_op(name)
    except NotImplementedError:
        raise AttributeError("mx.nd has no operator %r" % name) from None
    w = _make_wrapper(name, op)
    setattr(sys.modules[__name__], name, w)
    return w
