"""``mx.sym.contrib`` (port of ``incubator_mxnet_tpu/symbol/contrib.py``):
``mx.sym.contrib.<name>`` composes a node of the ``_contrib_<name>`` op
(or of ``<name>``), as ``mx.sym.<name>`` does, and the symbolic control
flow of the reference (``python/mxnet/symbol/contrib.py``: ``foreach``
:92, ``while_loop`` :272, ``cond`` :459).

A control-flow node holds its body as subgraph attributes (nested JSON in
the saved file) and takes as inputs the data, the states and the body's
free variables (outer symbols it captures, cut from the graph as the
reference's ``_get_graph_inputs`` cuts them); ``ops/control_flow.py``
runs it.
"""
from __future__ import annotations

import sys

from ..name import NameManager
from ..ops import control_flow as _control_flow  # noqa: F401  (registers)
from ..ops import registry as _reg
from .symbol import Group, Symbol, _Node, _toposort, var

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _free_variables(subgraph, exclude_names):
    """The subgraph's variables other than the loop's own inputs."""
    return [Symbol([(n, 0)])
            for n in _toposort([n for n, _ in subgraph._outputs])
            if n.is_var and n.name not in exclude_names
            and n.name != "__null__"]


def _make_cf_node(opname, name_hint, entries_syms, attrs, num_outputs, name):
    name = NameManager.current().get(name, name_hint)
    node = _Node(opname, name, attrs, [s._outputs[0] for s in entries_syms],
                 num_outputs=num_outputs)
    return list(Symbol([(node, i) for i in range(num_outputs)]))


def foreach(body, data, init_states, name="foreach"):
    """Symbolic scan: ``body(data_t, states) -> (outputs, new_states)``
    over axis 0 of ``data``; returns ``(outputs stacked over t, final
    states)``."""
    data_list = _as_list(data)
    states_list = _as_list(init_states)
    single_state = not isinstance(init_states, (list, tuple))
    data_names = tuple("__foreach_data%d" % i for i in range(len(data_list)))
    state_names = tuple("__foreach_state%d" % i
                        for i in range(len(states_list)))
    dvars = [var(n) for n in data_names]
    svars = [var(n) for n in state_names]
    outs, out_states = body(dvars[0] if len(dvars) == 1 else dvars,
                            svars[0] if single_state else svars)
    outs, out_states = _as_list(outs), _as_list(out_states)
    if len(out_states) != len(states_list):
        raise ValueError("body must return as many states as init_states")
    subgraph = Group(outs + out_states)
    free = _free_variables(subgraph, set(data_names) | set(state_names))
    attrs = dict(subgraph=subgraph, data_names=data_names,
                 state_names=state_names,
                 free_names=tuple(s.name for s in free),
                 num_out_data=len(outs))
    res = _make_cf_node("_foreach", "foreach", data_list + states_list + free,
                        attrs, len(outs) + len(out_states), name)
    out = res[0] if len(outs) == 1 else res[:len(outs)]
    st = res[len(outs):]
    return out, (st[0] if single_state else st)


def while_loop(cond, func, loop_vars, max_iterations=None, name="while_loop"):
    """Symbolic bounded while loop: ``cond(*vars)`` a scalar symbol,
    ``func(*vars) -> (step outputs, new vars)``; returns ``(outputs in
    max_iterations rows, final vars)``."""
    if max_iterations is None:
        raise ValueError("max_iterations is required")
    single_var = not isinstance(loop_vars, (list, tuple))
    vars_list = _as_list(loop_vars)
    var_names = tuple("__while_var%d" % i for i in range(len(vars_list)))
    vvars = [var(n) for n in var_names]
    cond_graph = Group([cond(*vvars)])
    outs, new_vars = func(*vvars)
    outs, new_vars = _as_list(outs), _as_list(new_vars)
    if len(new_vars) != len(vars_list):
        raise ValueError("func must return as many loop_vars as it consumes")
    body_graph = Group(outs + new_vars)
    free_syms = {}
    for s in _free_variables(cond_graph, set(var_names)) + \
            _free_variables(body_graph, set(var_names)):
        free_syms[s.name] = s
    free = list(free_syms.values())
    attrs = dict(cond_graph=cond_graph, body_graph=body_graph,
                 var_names=var_names,
                 free_names=tuple(s.name for s in free),
                 max_iterations=int(max_iterations),
                 num_out_data=len(outs))
    res = _make_cf_node("_while_loop", "while_loop", vars_list + free, attrs,
                        len(outs) + len(new_vars), name)
    out = res[0] if len(outs) == 1 else res[:len(outs)]
    vs = res[len(outs):]
    return out, (vs[0] if single_var else vs)


def cond(pred, then_func, else_func, inputs=None, name="cond"):
    """Symbolic conditional: ``pred`` (a symbol or a closure returning
    one) picks ``then_func()`` or ``else_func()``, closures over outer
    symbols with outputs of equal number and shapes."""
    pred_graph = Group([pred() if callable(pred) else pred])
    then_out = _as_list(then_func())
    else_out = _as_list(else_func())
    if len(then_out) != len(else_out):
        raise ValueError("then and else branches must produce the same "
                         "number of outputs")
    then_graph, else_graph = Group(then_out), Group(else_out)
    free_syms = {}
    for g in (pred_graph, then_graph, else_graph):
        for s in _free_variables(g, set()):
            free_syms[s.name] = s
    free = list(free_syms.values())
    attrs = dict(pred_graph=pred_graph, then_graph=then_graph,
                 else_graph=else_graph, pred_names=(), branch_names=(),
                 free_names=tuple(s.name for s in free))
    res = _make_cf_node("_cond", "cond", free, attrs, len(then_out), name)
    return res[0] if len(then_out) == 1 else res


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from . import _make_wrapper

    for cand in ("_contrib_" + name, name):
        if cand in _reg.OPS:
            w = _make_wrapper(name, _reg.OPS[cand])
            setattr(sys.modules[__name__], name, w)
            return w
    raise AttributeError("mx.sym.contrib has no operator %r" % name)
