"""Symbol: the symbolic graph IR (port of
``incubator_mxnet_tpu/symbol/symbol.py``, ``python/mxnet/symbol/symbol.py``).

A graph of ``_Node``s, each an op application or a variable, composed by
the ``sym.*`` wrappers of :mod:`.`, which create the missing parameter
inputs as variables named ``<node>_<input>`` (``fc1_weight``) as nnvm's
composition does.  It lists its arguments, auxiliary states and outputs,
infers shapes and types (parameter shapes backward from the data's,
:func:`_param_shape_rules`, the reference's ``FInferShape`` fixed point;
everything else by running the ops on ``meta`` tensors,
:meth:`..ops.registry.Op.infer`), and saves and loads the reference's
JSON byte for byte, so ``-symbol.json`` files cross between the JAX
package and the port both ways (a control-flow node's subgraphs as
nested JSON in ``__subgraph_json__:`` attributes).  ``bind``/``simple_bind`` make an
:class:`..executor.Executor`, which walks the graph eagerly on the bound
tensors.
"""
from __future__ import annotations

import ast
import inspect
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import context
from ..attribute import AttrScope
from ..base import MXNetError, np_dtype, torch_dtype
from ..name import NameManager
from ..ops import registry as _reg

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "AUX_SUFFIXES", "PARAM_INPUT_NAMES"]

#: input names that denote auxiliary state (mutated by the op, never a
#: gradient target: BatchNorm's running stats)
AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean", "running_var")

#: op input names that are parameters (auto-created at composition)
PARAM_INPUT_NAMES = {"weight", "bias", "gamma", "beta", "moving_mean",
                     "moving_var", "alpha", "parameters", "state",
                     "state_cell"}

#: optional op inputs, besides the parameters, that take a graph entry
_OPTIONAL_INPUT_NAMES = ("sequence_length", "label_lengths", "data_lengths",
                         "r1_r2", "min_bias", "max_bias", "valid_length",
                         "max_time")


class _Node:
    """One graph node: an op application or a variable (``op`` None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "_attr_dict")

    def __init__(self, op: Optional[str], name: str, attrs=None, inputs=None,
                 num_outputs=1):
        self.op = op
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs: List[Tuple["_Node", int]] = list(inputs or [])
        self.num_outputs = num_outputs
        self._attr_dict = {}

    @property
    def is_var(self):
        return self.op is None


def _toposort(heads: Sequence[_Node]) -> List[_Node]:
    """Every node the heads reach, inputs before their users, in the
    reference's depth-first order (the order of ``list_arguments``)."""
    seen = set()
    order: List[_Node] = []
    stack = [(h, False) for h in reversed(heads)]
    while stack:
        node, processed = stack.pop()
        if processed:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for parent, _ in reversed(node.inputs):
            if id(parent) not in seen:
                stack.append((parent, False))
    return order


class Symbol:
    """Handle to one or more outputs of a graph."""

    __is_symbol__ = True

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = list(outputs)

    # ------------------------------------------------------------ meta
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def attr(self, key):
        return self._outputs[0][0]._attr_dict.get(key)

    def list_attr(self):
        return dict(self._outputs[0][0]._attr_dict)

    def attr_dict(self):
        return {node.name: dict(node._attr_dict)
                for node in self._all_nodes() if node._attr_dict}

    def __repr__(self):
        if len(self._outputs) == 1:
            return "<Symbol %s>" % self.name
        return "<Symbol group [%s]>" % ", ".join(n.name
                                                 for n, _ in self._outputs)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        node = self._outputs[0][0]
        if len(self._outputs) == 1 and node.num_outputs > 1:
            return Symbol([(node, index)])
        return Symbol([self._outputs[index]])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        # nodes are immutable by convention: sharing them is a copy
        return Symbol(list(self._outputs))

    # ------------------------------------------------------------ listing
    def _all_nodes(self):
        return _toposort([n for n, _ in self._outputs])

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._all_nodes()
                if n.is_var and n.name != "__null__"
                and not n.name.endswith(AUX_SUFFIXES)]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._all_nodes()
                if n.is_var and n.name.endswith(AUX_SUFFIXES)]

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._all_nodes()
                if n.is_var and n.name != "__null__"]

    def list_outputs(self) -> List[str]:
        return ["%s_output%d" % (node.name, idx) if node.num_outputs > 1
                else "%s_output" % node.name for node, idx in self._outputs]

    def get_internals(self) -> "Symbol":
        return Symbol([(node, i) for node in self._all_nodes()
                       for i in range(node.num_outputs)])

    def get_children(self) -> Optional["Symbol"]:
        node = self._outputs[0][0]
        return Symbol(list(node.inputs)) if node.inputs else None

    # ------------------------------------------------------------ arithmetic
    _SCALAR_OPS = {
        "broadcast_add": ("_plus_scalar", "_plus_scalar"),
        "broadcast_sub": ("_minus_scalar", "_rminus_scalar"),
        "broadcast_mul": ("_mul_scalar", "_mul_scalar"),
        "broadcast_div": ("_div_scalar", "_rdiv_scalar"),
        "broadcast_power": ("_power_scalar", "_rpower_scalar"),
        "broadcast_mod": ("_mod_scalar", "_rmod_scalar"),
        "broadcast_equal": ("_equal_scalar", "_equal_scalar"),
        "broadcast_not_equal": ("_not_equal_scalar", "_not_equal_scalar"),
        "broadcast_greater": ("_greater_scalar", "_lesser_scalar"),
        "broadcast_greater_equal": ("_greater_equal_scalar",
                                    "_lesser_equal_scalar"),
        "broadcast_lesser": ("_lesser_scalar", "_greater_scalar"),
        "broadcast_lesser_equal": ("_lesser_equal_scalar",
                                   "_greater_equal_scalar"),
    }

    def _binop(self, other, opname, reverse=False):
        name = NameManager.current().get(None, opname.strip("_").lower())
        if isinstance(other, (int, float)):
            node = _Node(self._SCALAR_OPS[opname][reverse], name,
                         {"scalar": float(other)}, [self._outputs[0]])
            return Symbol([(node, 0)])
        lhs, rhs = (other, self) if reverse else (self, other)
        node = _Node(opname, name, {}, [lhs._outputs[0], rhs._outputs[0]])
        return Symbol([(node, 0)])

    def __add__(self, other):
        return self._binop(other, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", reverse=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", reverse=True)

    def __pow__(self, other):
        return self._binop(other, "broadcast_power")

    def __neg__(self):
        return self.__mul__(-1.0)

    def __eq__(self, other):
        return self._binop(other, "broadcast_equal") if isinstance(
            other, (Symbol, int, float)) else NotImplemented

    def __ne__(self, other):
        return self._binop(other, "broadcast_not_equal") if isinstance(
            other, (Symbol, int, float)) else NotImplemented

    def __gt__(self, other):
        return self._binop(other, "broadcast_greater")

    def __ge__(self, other):
        return self._binop(other, "broadcast_greater_equal")

    def __lt__(self, other):
        return self._binop(other, "broadcast_lesser")

    def __le__(self, other):
        return self._binop(other, "broadcast_lesser_equal")

    def __hash__(self):
        return id(self)

    # the ops commonly called as methods
    def _method_op(self, opname, **kwargs):
        from . import _invoke_symbol

        return _invoke_symbol(opname, [self], kwargs)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return self._method_op("Reshape", shape=shape, **kwargs)

    def transpose(self, axes=None):
        return self._method_op("transpose", axes=axes)

    def flatten(self):
        return self._method_op("Flatten")

    def sum(self, axis=None, keepdims=False):  # noqa: A003
        return self._method_op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._method_op("mean", axis=axis, keepdims=keepdims)

    def slice_axis(self, axis, begin, end):
        return self._method_op("slice_axis", axis=axis, begin=begin, end=end)

    def expand_dims(self, axis):
        return self._method_op("expand_dims", axis=axis)

    def softmax(self, axis=-1):
        return self._method_op("softmax", axis=axis)

    # ------------------------------------------------------------ inference
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes given
        by position (in ``list_arguments`` order) or by name; raises
        where a node's inputs cannot be resolved."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None where a shape is unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known: Dict[str, Tuple[int, ...]] = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        shapes, _ = _infer_graph(self, known, {}, partial=partial)
        return ([shapes.get(n) for n in self.list_arguments()],
                [shapes.get(_entry_key(node, i)) for node, i in self._outputs],
                [shapes.get(n) for n in self.list_auxiliary_states()])

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes; as in
        the reference, only entries whose shapes are known too (a
        variable's ``shape``) are evaluated, the rest read float32."""
        known: Dict[str, Any] = {}
        for name, dt in zip(self.list_arguments(), args):
            if dt is not None:
                known[name] = np_dtype(dt)
        known.update({k: np_dtype(v) for k, v in kwargs.items()
                      if v is not None})
        _, dtypes = _infer_graph(self, {}, known, partial=True)
        f32 = np.dtype(np.float32)
        return ([dtypes.get(n, f32) for n in self.list_arguments()],
                [dtypes.get(_entry_key(node, i), f32)
                 for node, i in self._outputs],
                [dtypes.get(n, f32) for n in self.list_auxiliary_states()])

    # ------------------------------------------------------------ execution
    def eval_with(self, bindings):
        """Evaluate eagerly on NDArrays (or tensors) given by variable name
        in ``bindings``, no running stat committed (``SymbolBlock``'s
        forward); an NDArray, or a list of them for several outputs."""
        from ..ndarray import NDArray

        vals = {k: (v._data if isinstance(v, NDArray) else v)
                for k, v in bindings.items()}
        device = next((v.device for v in vals.values()), None)
        outs = [NDArray(o) for o in _eval_graph(self, vals, device)]
        return outs[0] if len(outs) == 1 else outs

    def eval(self, ctx=None, **kwargs):  # noqa: A003
        """:meth:`eval_with` of the keyword arguments."""
        return self.eval_with(kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Bind to zero-filled arrays on ``ctx`` (``None``: the card) of
        the shapes inferred from ``kwargs``, with gradient buffers for
        every argument whose ``grad_req`` is not ``"null"``."""
        from ..executor import Executor
        from ..ndarray import zeros

        device = context.resolve(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        type_dict = type_dict or {}
        req = grad_req if isinstance(grad_req, dict) else {
            n: grad_req for n in arg_names}
        args, args_grad = {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            if shape is None:
                raise MXNetError("simple_bind could not infer shape of %r"
                                 % name)
            dtype = type_dict.get(name, "float32")
            args[name] = zeros(shape, ctx=device, dtype=dtype)
            if req.get(name, "write") != "null":
                args_grad[name] = zeros(shape, ctx=device, dtype=dtype)
        aux_states = {n: zeros(s, ctx=device) for n, s in
                      zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, device, args, args_grad, grad_req, aux_states)

    # ------------------------------------------------------------ files
    def tojson(self) -> str:
        """The graph in the reference's JSON (nnvm's layout: ``nodes``,
        ``arg_nodes``, ``node_row_ptr``, ``heads``, ``attrs``)."""
        nodes = self._all_nodes()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        arg_nodes = []
        for i, node in enumerate(nodes):
            if node.is_var:
                arg_nodes.append(i)
            entry = {
                "op": node.op if node.op else "null",
                "name": node.name,
                "inputs": [[node_ids[id(p)], idx, 0]
                           for p, idx in node.inputs],
            }
            if node.attrs:
                entry["attrs"] = {k: _attr_to_str(v)
                                  for k, v in node.attrs.items()}
            if node.num_outputs != 1:
                entry["num_outputs"] = node.num_outputs
            out_nodes.append(entry)
        heads = [[node_ids[id(n)], idx, 0] for n, idx in self._outputs]
        return json.dumps({
            "nodes": out_nodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 10600],
                      "framework": ["str", "incubator-mxnet-tpu"]},
        }, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


#: the prefix of an attribute that holds a subgraph (a control-flow
#: node's body) as nested JSON
_SUBGRAPH_PREFIX = "__subgraph_json__:"


def _attr_to_str(v):
    if isinstance(v, str):
        return v
    if isinstance(v, Symbol):
        return _SUBGRAPH_PREFIX + v.tojson()
    return repr(v)


def _parse_attr(s):
    if not isinstance(s, str):
        return s
    if s.startswith(_SUBGRAPH_PREFIX):
        return load_json(s[len(_SUBGRAPH_PREFIX):])
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _entry_key(node: _Node, idx: int) -> str:
    return "%s#%d" % (node.name, idx)


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs) -> Symbol:
    """A variable symbol (``sym.var``/``sym.Variable``)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = _Node(None, name)
    node._attr_dict.update(AttrScope.current().get(attr) or {})
    if shape is not None:
        node.attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        node.attrs["__dtype__"] = str(np_dtype(dtype))
    return Symbol([(node, 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:  # noqa: N802 - the reference's name
    return Symbol([o for s in symbols for o in s._outputs])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """A symbol from its JSON, the reference's or stock MXNet's: op
    parameters under ``attrs`` or the legacy ``param``, a node's other
    attributes under the legacy ``attr``, heads of 2 or 3 entries, and a
    multi-output node's arity taken from the highest output referenced
    where the file does not record ``num_outputs``."""
    data = json.loads(json_str)
    nodes: List[_Node] = []
    max_ref: Dict[int, int] = {}
    for entry in data["nodes"]:
        op = entry.get("op")
        op = None if op in (None, "null") else op
        attrs = {k: _parse_attr(v) for k, v in
                 (entry.get("attrs") or entry.get("param") or {}).items()}
        shape_attr = attrs.pop("__shape__", None)
        dtype_attr = attrs.pop("__dtype__", None)
        node = _Node(op, entry["name"], attrs,
                     num_outputs=entry.get("num_outputs", 1))
        if isinstance(entry.get("attr"), dict):
            node._attr_dict.update(entry["attr"])
        if shape_attr is not None:
            node.attrs["__shape__"] = tuple(shape_attr)
        if dtype_attr is not None:
            node.attrs["__dtype__"] = dtype_attr
        for inp in entry.get("inputs", []):
            node.inputs.append((nodes[inp[0]], inp[1]))
            max_ref[inp[0]] = max(max_ref.get(inp[0], 0), inp[1])
        nodes.append(node)
    heads = data.get("heads") or [[len(nodes) - 1, 0]]
    for h in heads:
        max_ref[h[0]] = max(max_ref.get(h[0], 0), h[1])
    for i, node in enumerate(nodes):
        if not node.is_var and max_ref.get(i, 0) + 1 > node.num_outputs:
            node.num_outputs = max_ref[i] + 1
    return Symbol([(nodes[h[0]], h[1]) for h in heads])


# ---------------------------------------------------------------------------
# evaluation and inference
# ---------------------------------------------------------------------------


def _op_attrs(node: _Node):
    return {k: v for k, v in node.attrs.items() if not k.startswith("__")}


def _eval_node(node: _Node, in_vals: List[Any], device=None):
    """The node's outputs as a list of tensors, its inputs cast by the
    AMP policy of the moment.  An op without tensor inputs that takes
    ``ctx`` (``_zeros``) builds on ``device``."""
    op = _reg.get_op(node.op)
    attrs = _op_attrs(node)
    if not in_vals and "ctx" in inspect.signature(op.fn).parameters:
        attrs.setdefault("ctx", device)
    out = op.fn(*_reg.amp_cast_inputs(op, in_vals, attrs), **attrs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _eval_graph(symbol: Symbol, bindings: Dict[str, Any],
                device=None) -> List[Any]:
    """The symbol's outputs on tensors bound by variable name."""
    cache: Dict[Tuple[int, int], Any] = {}
    for node in symbol._all_nodes():
        if node.is_var:
            if node.name == "__null__":
                cache[(id(node), 0)] = None
                continue
            if node.name not in bindings:
                raise MXNetError("unbound variable %r" % node.name)
            cache[(id(node), 0)] = bindings[node.name]
        else:
            in_vals = [cache[(id(p), i)] for p, i in node.inputs]
            for i, o in enumerate(_eval_node(node, in_vals, device)):
                cache[(id(node), i)] = o
    return [cache[(id(n), i)] for n, i in symbol._outputs]


def _param_shape_rules(node: _Node, data_shape, known):
    """Shapes of a node's parameter inputs from its data's shape (the
    reference's per-op ``FInferShape`` filling unknown arguments,
    ``infer_graph_attr_pass.cc``), for the ops the port registers; the
    reference's rules for its other ops come with them."""
    op = node.op
    a = node.attrs
    out = {}
    if op == "FullyConnected":
        num_hidden = int(a.get("num_hidden"))
        in_units = int(np.prod(data_shape[1:])) if a.get("flatten", True) \
            else data_shape[-1]
        out["weight"] = (num_hidden, in_units)
        out["bias"] = (num_hidden,)
    elif op == "Convolution":
        nf = int(a.get("num_filter"))
        ng = int(a.get("num_group", 1))
        out["weight"] = (nf, data_shape[1] // ng) + tuple(a.get("kernel"))
        out["bias"] = (nf,)
    elif op == "Deconvolution":
        nf = int(a.get("num_filter"))
        ng = int(a.get("num_group", 1))
        out["weight"] = (data_shape[1], nf // ng) + tuple(a.get("kernel"))
        out["bias"] = (nf,)
    elif op in ("BatchNorm", "InstanceNorm"):
        c = data_shape[int(a.get("axis", 1))]
        out["gamma"] = out["beta"] = (c,)
        out["moving_mean"] = out["moving_var"] = (c,)
    elif op == "LayerNorm":
        out["gamma"] = out["beta"] = (data_shape[int(a.get("axis", -1))],)
    elif op == "GroupNorm":
        out["gamma"] = out["beta"] = (data_shape[1],)
    elif op in ("LinearRegressionOutput", "MAERegressionOutput",
                "LogisticRegressionOutput", "linear_regression_output",
                "mae_regression_output", "logistic_regression_output"):
        out["label"] = tuple(data_shape)
    elif op == "LeakyReLU" and a.get("act_type") == "prelu":
        out["gamma"] = (data_shape[1] if len(data_shape) > 1 else 1,)
    elif op == "Embedding":
        out["weight"] = (int(a.get("input_dim")), int(a.get("output_dim")))
    elif op in ("SoftmaxOutput", "Softmax", "softmax_output"):
        if a.get("multi_output"):
            out["label"] = (data_shape[0],) + tuple(data_shape[2:])
        elif a.get("preserve_shape"):
            out["label"] = tuple(data_shape[:-1])
        else:
            out["label"] = (data_shape[0],)
    elif op == "RNN":
        from ..ops import rnn as rnn_ops

        layers, hidden = int(a.get("num_layers", 1)), int(a.get("state_size"))
        bidirectional = bool(a.get("bidirectional", False))
        out["parameters"] = (rnn_ops.rnn_param_size(
            layers, data_shape[-1], hidden, a.get("mode", "lstm"),
            bidirectional),)
        out["state"] = (layers * (2 if bidirectional else 1), data_shape[1],
                        hidden)
        out["state_cell"] = out["state"]
    return out


def _input_arg_names(op: _reg.Op):
    """The op's tensor inputs in order: positional parameters without a
    default, plus the parameter and optional inputs named above; None for
    a variadic op."""
    try:
        sig = inspect.signature(op.fn)
    except (TypeError, ValueError):
        return []
    names = []
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return None
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            if p.default is inspect.Parameter.empty \
                    or p.name in PARAM_INPUT_NAMES \
                    or p.name in _OPTIONAL_INPUT_NAMES:
                names.append(p.name)
    return names


def _required_arg_names(op: _reg.Op):
    """Inputs without a default: bound or auto-created at composition."""
    try:
        sig = inspect.signature(op.fn)
    except (TypeError, ValueError):
        return set()
    return {p.name for p in sig.parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)
            and p.default is inspect.Parameter.empty}


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def _infer_graph(symbol: Symbol, known_shapes, known_dtypes, partial=False):
    """Evaluate the graph on ``meta`` tensors, solving unknown parameter
    shapes by :func:`_param_shape_rules`; returns ``({name or entry:
    shape}, {name or entry: numpy dtype})``."""
    shapes: Dict[str, Any] = dict(known_shapes)
    dtypes: Dict[str, Any] = dict(known_dtypes)
    metas: Dict[Tuple[int, int], torch.Tensor] = {}
    null_entries = set()
    for node in symbol._all_nodes():
        if node.is_var:
            if node.name == "__null__":
                null_entries.add((id(node), 0))
                continue
            shape = shapes.get(node.name, node.attrs.get("__shape__"))
            if shape is not None and all(s > 0 for s in shape):
                dt = np_dtype(dtypes.get(node.name,
                                         node.attrs.get("__dtype__",
                                                        "float32")))
                metas[(id(node), 0)] = _meta(shape, dt)
                shapes[node.name] = tuple(shape)
                dtypes[node.name] = dt
            continue
        op = _reg.get_op(node.op)
        data = metas.get((id(node.inputs[0][0]), node.inputs[0][1])) \
            if node.inputs else None
        if data is not None:
            rules = _param_shape_rules(node, tuple(data.shape), shapes)
            arg_names = _input_arg_names(op) or []
            for pos, (parent, pidx) in enumerate(node.inputs):
                argname = arg_names[pos] if pos < len(arg_names) else None
                if parent.is_var and (id(parent), pidx) not in metas \
                        and argname in rules:
                    dt = np_dtype(dtypes.get(parent.name, data.dtype))
                    shapes[parent.name] = rules[argname]
                    dtypes[parent.name] = dt
                    metas[(id(parent), 0)] = _meta(rules[argname], dt)
        in_metas = []
        for parent, pidx in node.inputs:
            key = (id(parent), pidx)
            if key in null_entries:
                in_metas.append(None)
            elif key in metas:
                in_metas.append(metas[key])
            else:
                break
        if len(in_metas) < len(node.inputs):
            if partial:
                continue
            unresolved = [p.name for p, i in node.inputs
                          if (id(p), i) not in metas
                          and (id(p), i) not in null_entries]
            raise MXNetError("infer_shape: cannot resolve inputs %s of node "
                             "%s(%s)" % (unresolved, node.op, node.name))
        outs = op.infer(in_metas, **_op_attrs(node))
        node.num_outputs = len(outs)
        for i, o in enumerate(outs):
            metas[(id(node), i)] = o
            shapes[_entry_key(node, i)] = tuple(o.shape)
            dtypes[_entry_key(node, i)] = np_dtype(o.dtype)
    return shapes, dtypes
