"""Imperative autograd with MXNet's semantics over PyTorch's (port of
``incubator_mxnet_tpu/autograd.py``).

The two frameworks record differently.  PyTorch records every op whose
input requires a gradient; MXNet records only inside :func:`record`.  The
port keeps MXNet's rule: ``ops.registry.invoke`` runs an op with grad mode
on only while recording, so the graph is PyTorch's but holds only the ops
MXNet would have taped.

Gradients land in the buffers that ``attach_grad``/:func:`mark_variables`
attach, by ``grad_req``: ``write`` overwrites, ``add`` accumulates,
``null`` skips.  :func:`backward` finds the marked variables by walking the
graph back from the heads, so it writes only those the heads reach, as the
reference's tape walk does.  With ``retain_graph=False`` the graph is
freed and the heads are cut from it, so a second ``backward`` raises the
reference's ``ValueError``.  A marked variable's tensor is a leaf that
requires a gradient; NDArray's in-place operators swap that tensor for a
new leaf rather than writing into it, so PyTorch's version counter never
trips on a tensor a recorded op saved.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(is_record: bool) -> bool:
    s = _st()
    prev, s.recording = s.recording, bool(is_record)
    return prev


def set_training(train_mode_: bool) -> bool:
    s = _st()
    prev, s.training = s.training, bool(train_mode_)
    return prev


@contextlib.contextmanager
def _scope(recording=None, training=None):
    prev_r = set_recording(recording) if recording is not None else None
    prev_t = set_training(training) if training is not None else None
    try:
        yield
    finally:
        if recording is not None:
            set_recording(prev_r)
        if training is not None:
            set_training(prev_t)


def record(train_mode=True):  # noqa: A002 - the reference's name
    """Scope in which ops are recorded for :func:`backward`."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode=False):
    return _scope(recording=False, training=train_mode)


def train_mode():
    return _scope(training=True)


def predict_mode():
    return _scope(training=False)


def requires_grad(a) -> bool:
    """True for a marked variable or the output of a recorded op."""
    return a._data.requires_grad


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (``autograd.py:127``)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        v._grad = g
        v._grad_req = req
        v._set_data(v._data)


def _as_leaf(nd, t):
    """``t`` as a fresh leaf that requires a gradient and knows ``nd``."""
    t = t.detach().requires_grad_(True)
    t._mx_variable = weakref.ref(nd)
    return t


def _reached_variables(heads):
    """``(NDArray, leaf)`` for each marked variable's leaf that the heads'
    graph reaches.  A variable whose tensor was swapped after the forward
    (``w -= ...``) is found through the leaf the graph saw."""
    seen = set()
    found = []
    stack = [h._data.grad_fn for h in heads]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        leaf = getattr(fn, "variable", None)
        if leaf is not None:
            ref = getattr(leaf, "_mx_variable", None)
            nd = ref() if ref is not None else None
            if nd is not None:
                found.append((nd, leaf))
            continue
        stack.extend(f for f, _ in fn.next_functions)
    return found


def _recorded_heads(heads, head_grads):
    """The heads that a recorded op produced, and their head gradients
    (ones where none is given).  Raises if there is none."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    pairs = [(h, torch.ones_like(h._data) if g is None else g._data)
             for h, g in zip(heads, head_grads)
             if h._data.grad_fn is not None]
    if not pairs:
        raise ValueError(
            "cannot differentiate: no recorded computation reaches the heads "
            "(is autograd.record() active and do inputs have attach_grad()?)")
    return [h for h, _ in pairs], [g for _, g in pairs]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):  # noqa: A002
    """Accumulate the heads' gradients into the marked variables they
    reach, honouring each one's ``grad_req``."""
    heads, head_grads = _recorded_heads(heads, head_grads)
    pairs = [(v, leaf) for v, leaf in _reached_variables(heads)
             if v._grad_req != "null"]
    grads = torch.autograd.grad(
        [h._data for h in heads], [leaf for _, leaf in pairs], head_grads,
        retain_graph=bool(retain_graph), allow_unused=True) if pairs else ()
    total = {}
    for (v, _), g in zip(pairs, grads):
        if g is not None:
            prev = total.get(id(v))
            total[id(v)] = (v, g if prev is None else prev[1] + g)
    for v, g in total.values():
        buf = v._grad
        if v._grad_req == "add":
            buf._data = buf._data + g.to(buf._data.dtype)
        else:
            buf._data = g.to(buf._data.dtype)
    if not retain_graph:
        for h in heads:
            h._data = h._data.detach()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # noqa: A002
    """The heads' gradients with respect to ``variables``, returned and not
    written to any buffer (``autograd.py:241``).  A variable the heads do
    not reach gets zeros."""
    from .ndarray import NDArray

    heads, head_grads = _recorded_heads(heads, head_grads)
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    retain = bool(create_graph if retain_graph is None else retain_graph)
    gs = torch.autograd.grad(
        [h._data for h in heads], [v._data for v in variables], head_grads,
        retain_graph=retain, create_graph=bool(create_graph),
        allow_unused=True)
    out = [NDArray(torch.zeros_like(v._data) if g is None else g)
           for v, g in zip(variables, gs)]
    if not retain:
        for h in heads:
            h._data = h._data.detach()
    return out[0] if single else out


class _FunctionBridge(torch.autograd.Function):
    """Runs a user :class:`Function`'s forward and backward on NDArrays,
    with recording paused as the reference does."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray import NDArray

        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        fn._single_output = not isinstance(outs, (list, tuple))
        outs = [outs] if fn._single_output else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray

        with pause():
            gs = ctx.fn.backward(*[NDArray(g) for g in grads])
        gs = list(gs) if isinstance(gs, (list, tuple)) else [gs]
        return (None, *[None if g is None else g._data for g in gs])


class Function:
    """A user-defined differentiable function (``autograd.py:278``).

    Subclass it with ``forward(self, *inputs)`` and ``backward(self,
    *output_grads)`` on NDArrays; ``save_for_backward`` keeps what the
    backward needs."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def __call__(self, *inputs):
        from .ndarray import NDArray

        if not (is_recording() and any(requires_grad(i) for i in inputs)):
            with pause():
                return self.forward(*inputs)
        outs = [NDArray(t) for t in
                _FunctionBridge.apply(self, *[i._data for i in inputs])]
        return outs[0] if self._single_output else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
