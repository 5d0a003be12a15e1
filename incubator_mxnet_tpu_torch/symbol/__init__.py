"""``mx.sym``: the symbolic operator namespace (port of
``incubator_mxnet_tpu/symbol/__init__.py``).

A module ``__getattr__`` resolves any registered op name to a wrapper
that composes a graph node, as the reference code-generates both ``nd``
and ``sym`` from one registry.  Inputs not given are created as
variables named ``<node>_<input>`` (``fc1_weight``, ``softmax_label``),
as nnvm composition does; a bias with ``no_bias=True`` is bound to
nothing.  ``mx.sym.contrib`` resolves the ``_contrib_`` names and
composes the control flow (``foreach``, ``while_loop``, ``cond``);
``mx.sym.linalg`` the ``la_op`` family.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..name import NameManager
from ..ops import math as _math  # noqa: F401  (registers the ops)
from ..ops import nn as _nn  # noqa: F401
from ..ops import contrib as _contrib  # noqa: F401
from ..ops import contrib_tail as _contrib_tail  # noqa: F401
from ..ops import registry as _reg
from ..ops import tensor as _tensor  # noqa: F401
from .symbol import (AUX_SUFFIXES, PARAM_INPUT_NAMES, Group, Symbol, Variable,
                     _input_arg_names, _Node, _required_arg_names, load,
                     load_json, var)
from . import contrib  # noqa: E402  (mx.sym.contrib)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json", "zeros",
           "ones", "arange", "AUX_SUFFIXES", "contrib", "linalg"]

__is_symbol__ = True

# stands in for an absent optional input (a bias with no_bias=True):
# excluded from list_arguments and bound to None at evaluation
_NULL_NODE = _Node(None, "__null__")


def _compose_num_outputs(opname, attrs):
    """A new node's outputs, from the op's registration or its attributes
    (inference corrects a node loaded without them).  A ``Custom`` node
    has its prop's outputs."""
    if opname == "Custom":
        from ..operator import custom_num_outputs

        return custom_num_outputs(attrs.get("op_type"), {
            k: v for k, v in attrs.items() if k != "op_type"})
    op = _reg.OPS.get(opname)
    if op is not None and (op.num_outputs or 1) > 1:
        return op.num_outputs
    if opname in ("SliceChannel", "split"):
        return int(attrs.get("num_outputs", 2))
    if opname in ("split_v2", "_split_v2"):
        sections = int(attrs.get("sections", 0))
        return sections if sections else len(attrs.get("indices", ())) + 1
    if opname == "topk" and attrs.get("ret_typ") == "both":
        return 2
    if opname in ("BatchNorm", "batch_norm", "LayerNorm", "layer_norm",
                  "GroupNorm") and attrs.get("output_mean_var"):
        return 3
    if opname == "amp_multicast":
        return int(attrs.get("num_outputs", 1))
    if opname == "RNN" and attrs.get("state_outputs"):
        return 3 if attrs.get("mode", "lstm") == "lstm" else 2
    return 1


def _invoke_symbol(opname, inputs: List[Optional[Symbol]], attrs, name=None):
    op = _reg.get_op(opname)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    name = NameManager.current().get(name, opname.lower().strip("_"))
    arg_names = _input_arg_names(op)
    entries = []
    if arg_names is None:
        # a variadic op: every input is a positional symbol
        entries = [s._outputs[0] for s in inputs]
    else:
        no_bias = attrs.get("no_bias", False)
        required = _required_arg_names(op)
        for pos, argname in enumerate(arg_names):
            if pos < len(inputs) and inputs[pos] is not None:
                entries.append(inputs[pos]._outputs[0])
            elif isinstance(attrs.get(argname), Symbol):
                entries.append(attrs.pop(argname)._outputs[0])
            elif argname in PARAM_INPUT_NAMES or argname in required:
                if argname == "bias" and no_bias:
                    entries.append((_NULL_NODE, 0))
                else:
                    entries.append(var("%s_%s" % (name, argname))._outputs[0])
            elif pos < len(inputs):
                entries.append((_NULL_NODE, 0))
            else:
                break  # trailing optional inputs left out
    node = _Node(opname, name, attrs, entries,
                 num_outputs=_compose_num_outputs(opname, attrs))
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _make_wrapper(public_name, op):
    def wrapper(*args, name=None, attr=None, **kwargs):
        inputs = []
        for a in args:
            if not (isinstance(a, Symbol) or a is None):
                raise TypeError("mx.sym.%s expects Symbol inputs, got %r"
                                % (public_name, a))
            inputs.append(a)
        # Symbol-valued keywords that follow the positional inputs
        for n in (_input_arg_names(op) or [])[len(inputs):]:
            if isinstance(kwargs.get(n), Symbol):
                inputs.append(kwargs.pop(n))
            elif n in kwargs and kwargs[n] is None:
                kwargs.pop(n)
                inputs.append(None)
            else:
                break
        return _invoke_symbol(op.name, inputs, kwargs, name=name)

    wrapper.__name__ = public_name
    wrapper.__doc__ = op.doc
    return wrapper


def __getattr__(attr_name):
    if attr_name.startswith("__"):
        raise AttributeError(attr_name)
    try:
        op = _reg.get_op(attr_name)
    except NotImplementedError:
        raise AttributeError("mx.sym has no operator %r" % attr_name) from None
    w = _make_wrapper(attr_name, op)
    setattr(sys.modules[__name__], attr_name, w)
    return w


from . import linalg  # noqa: E402  (needs _invoke_symbol above)


def zeros(shape, dtype="float32", **kwargs):
    return _invoke_symbol("_zeros", [], {"shape": shape, "dtype": dtype},
                          **kwargs)


def ones(shape, dtype="float32", **kwargs):
    return _invoke_symbol("_ones", [], {"shape": shape, "dtype": dtype},
                          **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", **kwargs):
    return _invoke_symbol("_arange", [], {"start": start, "stop": stop,
                                          "step": step, "repeat": repeat,
                                          "dtype": dtype}, **kwargs)
