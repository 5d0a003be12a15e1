"""``mx.nd.contrib`` (port of ``incubator_mxnet_tpu/ndarray/contrib.py``):
``name`` resolves to the ``_contrib_name`` op (``nd.contrib.
flash_attention``, registered here over :mod:`..parallel.flash_attention`),
plus the eager control flow ``foreach``,
``while_loop`` and ``cond``, whose Python loops run on NDArrays so
autograd records every step.
"""
from __future__ import annotations

import sys

from ..ops import registry as _reg
from ..parallel.flash_attention import flash_attention as _flash_attention

__all__ = ["foreach", "while_loop", "cond"]


@_reg.register("_contrib_flash_attention", num_inputs=3)
def _flash_attention_op(q, k, v, causal=False, scale=None, block_q=None,
                        block_k=None):
    """Fused attention over (B, H, S, D) tensors (flash_attention.py:388):
    on the card K4 forward, K5/K6 backward."""
    return _flash_attention(
        q, k, v, causal=bool(causal), scale=scale,
        block_q=None if block_q is None else int(block_q),
        block_k=None if block_k is None else int(block_k))


def _as_list(obj):
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


def foreach(body, data, init_states, name="foreach"):
    """Iterate ``body(data_t, states)`` over axis 0 (contrib.py:187)."""
    from .ndarray import stack

    data_list = _as_list(data)
    states = _as_list(init_states)
    single_state = not isinstance(init_states, (list, tuple))
    outputs = None
    for i in range(data_list[0].shape[0]):
        eles = [d[i] for d in data_list]
        outs, states = body(eles[0] if len(eles) == 1 else eles,
                            states[0] if single_state else states)
        states = _as_list(states)
        outs = _as_list(outs)
        if outputs is None:
            outputs = [[] for _ in outs]
        for buf, o in zip(outputs, outs):
            buf.append(o)
    stacked = [stack(*buf, axis=0) for buf in (outputs or [])]
    out = stacked[0] if len(stacked) == 1 else stacked
    return out, (states[0] if single_state else states)


def while_loop(cond, func, loop_vars, max_iterations=None, name="while_loop"):
    """Bounded while loop (contrib.py:320).  Step outputs are stacked and
    zero-padded to ``max_iterations`` rows."""
    from .ndarray import stack

    if max_iterations is None:
        raise ValueError("max_iterations is required")
    single_var = not isinstance(loop_vars, (list, tuple))
    vs = _as_list(loop_vars)
    steps = []
    while len(steps) < max_iterations and bool(cond(*vs).asnumpy().item()):
        outs, new_vs = func(*vs)
        vs = _as_list(new_vs)
        steps.append(_as_list(outs))
    if not steps:
        raise ValueError("while_loop made zero iterations; output shapes "
                         "are undefined (matches the reference error)")
    outputs = []
    for j in range(len(steps[0])):
        rows = [s[j] for s in steps]
        pad = [rows[0] * 0] * (int(max_iterations) - len(rows))
        outputs.append(stack(*(rows + pad), axis=0))
    out = outputs[0] if len(outputs) == 1 else outputs
    return out, (vs[0] if single_var else vs)


def cond(pred, then_func, else_func, name="cond"):
    """Eager conditional (contrib.py:452)."""
    if bool(pred.asnumpy().item()):
        return then_func()
    return else_func()


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from . import _make_wrapper

    for cand in ("_contrib_" + name, name):
        if cand in _reg.OPS:
            w = _make_wrapper(name, _reg.OPS[cand])
            setattr(sys.modules[__name__], name, w)
            return w
    raise AttributeError("mx.nd.contrib has no operator %r" % name)
