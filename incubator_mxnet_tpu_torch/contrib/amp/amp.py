"""Automatic mixed precision (port of ``incubator_mxnet_tpu/contrib/amp/
amp.py``).

Two mechanisms, as in the reference:

- ``init()`` turns on a cast policy (``ops.registry.AMP_POLICY``): every
  dispatch of the port (``mx.nd``, Gluon's ``F`` and the symbolic
  executor) casts the floating inputs of the matmul and convolution ops
  to the target type (bfloat16 by default, float16 too) and those of the
  sensitive ops (norms, softmax, losses, exponentials, reductions) to
  float32.  Parameters stay float32 and get their gradients through the
  cast.
- ``convert_symbol()`` / ``convert_model()`` rewrite a graph with
  ``amp_cast`` nodes on the same ops' inputs, for deployment without the
  global policy.

``init_trainer`` attaches a ``LossScaler`` to a ``Trainer``,
``scale_loss`` multiplies a loss by its scale, and ``Trainer.step``
divides the gradients back, skipping the update and halving the scale on
overflow.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ...ops import registry as _reg
from .lists import symbol_bf16 as _lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_symbol", "convert_hybrid_block", "list_lp16_ops",
           "list_fp32_ops", "disable"]

_TARGETS = {"bfloat16": torch.bfloat16, "float16": torch.float16}

_amp_initialized = False
_loss_scaler: Optional[LossScaler] = None


def _expand(names):
    """The listed ops with their registry aliases."""
    out = set()
    for n in names:
        op = _reg.OPS.get(n)
        if op is not None:
            out.add(op.name)
            out.update(op.aliases)
        else:
            out.add(n)
    return frozenset(out)


def list_lp16_ops(target_dtype="bfloat16"):
    return list(_lists.FP16_FUNCS)


def list_fp32_ops(target_dtype="bfloat16"):
    return list(_lists.FP32_FUNCS)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn on the cast policy for ``target_dtype`` (``"bfloat16"`` or
    ``"float16"``), with the lists extended by ``target_precision_ops``
    and ``fp32_ops``; a new shared ``LossScaler`` starts at 1 for
    bfloat16 and at 2^16 for float16."""
    global _amp_initialized, _loss_scaler
    assert str(target_dtype) in _TARGETS, \
        "AMP target dtype must be bfloat16 or float16"
    lo = set(_lists.FP16_FUNCS)
    if target_precision_ops:
        lo.update(target_precision_ops)
    hi = set(_lists.FP32_FUNCS)
    if fp32_ops:
        hi.update(fp32_ops)
    cond = {}
    for name, attr, vals in (conditional_fp32_ops
                             or _lists.CONDITIONAL_FP32_FUNCS):
        for alias in _expand([name]):
            cond[alias] = (attr, {str(v) for v in vals})
    _reg.AMP_POLICY.update(active=True, target=_TARGETS[str(target_dtype)],
                           lo=_expand(lo), hi=_expand(hi), cond=cond)
    _amp_initialized = True
    _loss_scaler = LossScaler(
        init_scale=1.0 if target_dtype == "bfloat16" else 2.**16)


def disable():
    """Turn the policy off (the reference's test helper)."""
    global _amp_initialized
    _reg.AMP_POLICY.update(active=False, target=None, lo=frozenset(),
                           hi=frozenset(), cond={})
    _amp_initialized = False


def init_trainer(optimizer_or_trainer):
    """Attach the shared ``LossScaler`` to a ``Trainer``."""
    assert _amp_initialized, "call amp.init() before amp.init_trainer()"
    optimizer_or_trainer._amp_loss_scaler = _loss_scaler
    return optimizer_or_trainer


@contextlib.contextmanager
def scale_loss(loss, optimizer_or_trainer):
    """The loss (or each of a list) times the trainer's current scale;
    the trainer's ``step`` divides the gradients back."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        # scaling without the trainer knowing would apply gradients
        # loss_scale times too large
        raise ValueError(
            "trainer has no attached loss scaler: call "
            "amp.init_trainer(trainer) before amp.scale_loss")
    scale = scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scale for l in loss]
    else:
        yield loss * scale


def unscale(optimizer_or_trainer):
    """Divide the trainer's accumulated gradients by its loss scale."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None) \
        or _loss_scaler
    if scaler is None or scaler.loss_scale == 1.0:
        return
    inv = 1.0 / scaler.loss_scale
    params = getattr(optimizer_or_trainer, "_params", None)
    if params is None:
        return
    for p in params:
        if getattr(p, "grad_req", "write") != "null":
            g = p.grad()
            g[:] = g * inv


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, conditional_fp32_ops=None,
                   excluded_sym_names=None, data_names=None,
                   cast_optional_params=False):
    """A copy of ``sym`` with an ``amp_cast`` node (``amp_cast<N>``) on
    each input of every low-precision op (to ``target_dtype``) and of
    every float32 op or conditional match (to float32), but on absent
    optional inputs and in the nodes of ``excluded_sym_names``."""
    from ...symbol.symbol import Symbol, _Node, _toposort

    excluded = set(excluded_sym_names or ())
    lo = _expand(set(target_dtype_ops or _lists.FP16_FUNCS))
    hi = _expand(set(fp32_ops or _lists.FP32_FUNCS))
    cond_rules = {name: (attr, set(vals)) for name, attr, vals in
                  (conditional_fp32_ops or _lists.CONDITIONAL_FP32_FUNCS)}
    mapping = {}
    counter = [0]

    def cast_entry(entry, dtype):
        p, i = entry
        if p.is_var and p.name == "__null__":
            return entry
        counter[0] += 1
        return (_Node("amp_cast", "amp_cast%d" % counter[0],
                      {"dtype": dtype}, [(p, i)]), 0)

    for node in _toposort([n for n, _ in sym._outputs]):
        if node.is_var:
            mapping[id(node)] = node
            continue
        new_inputs = [(mapping[id(p)], i) for p, i in node.inputs]
        if node.name not in excluded:
            cond = cond_rules.get(node.op)
            if (cond is not None and str(node.attrs.get(cond[0])) in cond[1]) \
                    or node.op in hi:
                new_inputs = [cast_entry(e, "float32") for e in new_inputs]
            elif node.op in lo:
                new_inputs = [cast_entry(e, target_dtype)
                              for e in new_inputs]
        copy = _Node(node.op, node.name, dict(node.attrs), new_inputs,
                     num_outputs=node.num_outputs)
        copy._attr_dict.update(node._attr_dict)
        mapping[id(node)] = copy
    return Symbol([(mapping[id(n)], i) for n, i in sym._outputs])


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=None,
                  cast_optional_params=False):
    """``convert_symbol`` and the parameters, cast to ``target_dtype``
    with ``cast_optional_params``, else as they are."""
    new_sym = convert_symbol(sym, target_dtype, target_dtype_ops, fp32_ops,
                             conditional_fp32_ops, excluded_sym_names,
                             cast_optional_params=cast_optional_params)
    if cast_optional_params:
        arg_params = {k: v.astype(target_dtype)
                      for k, v in arg_params.items()}
        aux_params = {k: v.astype(target_dtype)
                      for k, v in aux_params.items()}
    return new_sym, dict(arg_params), dict(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16", **kwargs):
    """The block as it is, with the policy turned on if it was not: the
    block's ops dispatch through it."""
    if not _amp_initialized:
        init(target_dtype=target_dtype)
    return block
