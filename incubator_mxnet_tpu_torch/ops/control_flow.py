"""Control-flow ops over subgraphs (port of
``incubator_mxnet_tpu/ops/control_flow.py``; the reference's
``src/operator/control_flow.cc`` ``_foreach``, ``_while_loop``, ``_cond``).

A node's subgraph (a ``Symbol``) is one of its attributes, composed by
``mx.sym.contrib`` (``symbol/contrib.py``).  Each op runs it with the
executor's walk (``symbol._eval_graph``) in a Python loop on its inputs'
device, so ``torch.autograd`` differentiates through the loop as the
reference's ``jax.vjp`` does through its ``lax.scan``.  The semantics are
the reference's: ``_while_loop`` runs ``max_iterations`` masked steps
(rows after the loop ends are zero, the loop variables keep their last
values), ``_cond`` runs the branch its predicate picks (read on the host;
on ``meta`` tensors, shape inference, the then-branch).

Node inputs: ``[data..., states..., free variables...]``, their names in
the attributes.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _eval_sub(subgraph, bindings):
    from ..symbol.symbol import _eval_graph

    device = next((v.device for v in bindings.values() if v is not None),
                  None)
    return _eval_graph(subgraph, bindings, device)


def _one_or_tuple(out):
    return tuple(out) if len(out) != 1 else out[0]


@register("_foreach")
def _foreach(*arrays, subgraph=None, data_names=(), state_names=(),
             free_names=(), num_out_data=0):
    """The subgraph over axis 0 of each data input (control_flow.cc:1089):
    ``[stacked data outputs..., final states...]``."""
    nd_, ns = len(data_names), len(state_names)
    data = arrays[:nd_]
    states = list(arrays[nd_:nd_ + ns])
    free = dict(zip(free_names, arrays[nd_ + ns:]))
    steps = []
    for t in range(data[0].shape[0]):
        bind = dict(free)
        bind.update(zip(data_names, (d[t] for d in data)))
        bind.update(zip(state_names, states))
        outs = _eval_sub(subgraph, bind)
        steps.append(outs[:num_out_data])
        states = outs[num_out_data:]
    stacked = [torch.stack([s[i] for s in steps])
               for i in range(num_out_data)]
    return _one_or_tuple(stacked + list(states))


@register("_while_loop")
def _while_loop(*arrays, cond_graph=None, body_graph=None, var_names=(),
                free_names=(), max_iterations=0, num_out_data=0):
    """A bounded while loop (control_flow.cc:1150): ``max_iterations``
    steps, each live while every condition so far held; a step's outputs
    are written into ``max_iterations`` rows (zero once the loop ended).
    Returns ``[output rows..., final loop variables...]``."""
    nv = len(var_names)
    loop_vars = list(arrays[:nv])
    free = dict(zip(free_names, arrays[nv:]))
    alive = None
    rows = []
    for _ in range(int(max_iterations)):
        bind = dict(free)
        bind.update(zip(var_names, loop_vars))
        (c,) = _eval_sub(cond_graph, bind)
        c = c.to(torch.bool).reshape(())
        alive = c if alive is None else alive & c
        outs = _eval_sub(body_graph, bind)
        rows.append([torch.where(alive, o, torch.zeros_like(o))
                     for o in outs[:num_out_data]])
        loop_vars = [torch.where(alive, n, v)
                     for n, v in zip(outs[num_out_data:], loop_vars)]
    stacked = [torch.stack([r[i] for r in rows])
               for i in range(num_out_data)]
    return _one_or_tuple(stacked + loop_vars)


@register("_cond")
def _cond(*arrays, pred_graph=None, then_graph=None, else_graph=None,
          pred_names=(), branch_names=(), free_names=()):
    """The then- or else-subgraph by the predicate (control_flow.cc:1211)."""
    np_, nb = len(pred_names), len(branch_names)
    free = dict(zip(free_names, arrays[np_ + nb:]))
    bind = dict(free)
    bind.update(zip(pred_names, arrays[:np_]))
    (p,) = _eval_sub(pred_graph, bind)
    take = True if p.device.type == "meta" \
        else bool(p.to(torch.bool).reshape(()))
    bind = dict(free)
    bind.update(zip(branch_names, arrays[np_:np_ + nb]))
    return _one_or_tuple(_eval_sub(then_graph if take else else_graph, bind))
