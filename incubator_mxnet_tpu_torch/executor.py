"""Executor: a bound symbolic graph (port of
``incubator_mxnet_tpu/executor.py``, ``python/mxnet/executor.py``).

The reference compiles the whole graph into one ``jax.jit`` program;
the port walks it eagerly, node by node in topological order, on the
bound tensors, as its ``nd`` path runs.  :meth:`Executor.forward` with
``is_train`` records the walk for ``torch.autograd`` from fresh leaves of
the arguments that take a gradient and runs the ops in training mode
(``autograd.is_training()``: BatchNorm's batch statistics, Dropout);
:meth:`Executor.backward` takes the gradients of the outputs, with ones
as the head gradient unless ``out_grads`` are given, into ``grad_dict``
by each argument's ``grad_req`` (``write``, ``add`` or ``null``).  Each
op's ``aux_update`` (BatchNorm's and the ghost-BN ops' running stats,
from any of an op's outputs: the dual exit has four) is committed after a
training forward.  Every output of a node stays its own graph entry, so
the dual exit's two cotangents reach K2 apart.  The kernels on the path
(K3 in a max ``Pooling``, K1 and K2 in the ghost-BN ops) run as they do
under ``nd``; a control-flow node (``_foreach``, ``_while_loop``,
``_cond``) runs its subgraphs through the same walk
(``ops/control_flow.py``).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import autograd, context
from .base import MXNetError
from .ndarray import NDArray, zeros
from .ops import registry as _reg
from .symbol.symbol import Symbol, _eval_node, _op_attrs

__all__ = ["Executor"]


def _tensor(x, device):
    t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
    return t.detach().to(device)


class Executor:
    def __init__(self, symbol: Symbol, ctx, args, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._device = context.resolve(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, dict):
            self.arg_dict = {n: args[n] for n in arg_names}
        else:
            if len(args) != len(arg_names):
                raise MXNetError("bind: expected %d args (%s), got %d"
                                 % (len(arg_names), arg_names, len(args)))
            self.arg_dict = dict(zip(arg_names, args))
        if args_grad is None:
            self.grad_dict: Dict[str, NDArray] = {}
        elif isinstance(args_grad, dict):
            self.grad_dict = dict(args_grad)
        else:
            self.grad_dict = {n: g for n, g in zip(arg_names, args_grad)
                              if g is not None}
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req)
        if aux_states is None:
            self.aux_dict: Dict[str, NDArray] = {}
        elif isinstance(aux_states, dict):
            self.aux_dict = dict(aux_states)
        else:
            self.aux_dict = dict(zip(aux_names, aux_states))
        self._arg_names = arg_names
        self._aux_names = aux_names
        self.outputs: List[NDArray] = []
        self._pending = None
        self._monitor_callback = None
        self._monitor_all = False

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    # ------------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays, ``kwargs`` (name -> array)
        first written into ``arg_dict``.  Returns ``outputs``."""
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("unknown input %r" % name)
            self.arg_dict[name]._set_data(_tensor(val, self._device))
        leaves = {}
        if is_train:
            leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                      for n in self._arg_names
                      if self.grad_req.get(n, "write") != "null"
                      and n in self.grad_dict}
        bindings = {n: leaves.get(n, self.arg_dict[n]._data)
                    for n in self._arg_names}
        bindings.update({n: self.aux_dict[n]._data for n in self._aux_names})
        monitor = self._monitor_callback
        if monitor is not None and \
                not getattr(monitor, "is_active", lambda: True)():
            monitor = None
        with autograd._scope(recording=False, training=bool(is_train)), \
                torch.set_grad_enabled(bool(leaves)):
            outs, aux_writes = self._walk(bindings, is_train, monitor)
        for name, val in aux_writes.items():
            self.aux_dict[name]._set_data(val)
        self._pending = (leaves, outs) if is_train else None
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def _walk(self, bindings, is_train, monitor):
        """Every node in order; returns (output tensors, {aux name: new
        value}).  ``monitor`` is called on each node's outputs (and, with
        ``monitor_all``, its inputs) as the reference's monitor
        callback."""
        cache = {}
        aux_writes = {}
        for node in self._symbol._all_nodes():
            if node.is_var:
                cache[(id(node), 0)] = None if node.name == "__null__" \
                    else bindings[node.name]
                continue
            in_vals = [cache[(id(p), i)] for p, i in node.inputs]
            if monitor is not None and self._monitor_all:
                for (p, _), v in zip(node.inputs, in_vals):
                    if v is not None:
                        monitor("%s_%s" % (node.name, p.name),
                                NDArray(v.detach()))
            outs = _eval_node(node, in_vals, self._device)
            for i, o in enumerate(outs):
                cache[(id(node), i)] = o
                if monitor is not None:
                    monitor(node.name + ("_output" if i == 0
                                         else "_output%d" % i),
                            NDArray(o.detach()))
            op = _reg.OPS.get(node.op)
            if is_train and op is not None and op.aux_update is not None:
                with torch.no_grad():
                    updates = op.aux_update(
                        [None if v is None else v.detach() for v in in_vals],
                        outs, **_op_attrs(node))
                for idx, val in updates.items():
                    src = node.inputs[idx][0]
                    if src.is_var:
                        aux_writes[src.name] = val
        return [cache[(id(n), i)] for n, i in self._symbol._outputs], \
            aux_writes

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward's outputs (head
        gradient ones, or ``out_grads``) into ``grad_dict``."""
        if self._pending is None:
            raise MXNetError("backward called before forward(is_train=True)")
        leaves, outs = self._pending
        if not leaves:
            return
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [_tensor(g, self._device) for g in out_grads]
        names = list(leaves)
        live = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in live], [leaves[n] for n in names],
            [h for _, h in live], retain_graph=True,
            allow_unused=True) if live else [None] * len(names)
        for name, g in zip(names, grads):
            buf = self.grad_dict[name]
            if g is None:
                g = torch.zeros_like(leaves[name])
            g = g.to(buf._data.dtype)
            if self.grad_req.get(name, "write") == "add":
                g = buf._data + g
            buf._set_data(g)

    # ------------------------------------------------------------------
    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for the input shapes ``kwargs``, sharing the
        arrays whose shapes stay."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        args, grads = {}, {}
        for name, shape in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[name]
            args[name] = cur if tuple(shape) == cur.shape else zeros(
                shape, ctx=self._device, dtype=cur.dtype)
            if name in self.grad_dict:
                grads[name] = zeros(shape, ctx=self._device, dtype=cur.dtype)
        aux = {}
        for name, shape in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict.get(name)
            aux[name] = cur if cur is not None and cur.shape == tuple(shape) \
                else zeros(shape, ctx=self._device)
        return Executor(self._symbol, self._device, args, grads,
                        self.grad_req, aux)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, val in arg_params.items():
            if name in self.arg_dict:
                dst = self.arg_dict[name]
                dst._set_data(_tensor(val, self._device).to(dst._data.dtype))
            elif not allow_extra_params:
                raise MXNetError("unknown arg %r" % name)
        for name, val in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name]._set_data(_tensor(val, self._device))
            elif not allow_extra_params:
                raise MXNetError("unknown aux %r" % name)

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on every node's outputs at
        each forward (and its inputs with ``monitor_all``); a callback
        whose ``is_active()`` is false is skipped."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all
