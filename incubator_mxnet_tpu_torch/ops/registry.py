"""Operator registry (port of ``incubator_mxnet_tpu/ops/registry.py``).

Every op registers one implementation, ``fn``: a function on torch
tensors.  :func:`invoke` runs it on :class:`~..ndarray.NDArray` inputs
with MXNet's recording rule: an op is recorded for autograd only inside
``autograd.record()``, only if it is differentiable and only if an input
requires a gradient.  Otherwise it runs under ``torch.no_grad()`` and its
results are detached, so an array with ``attach_grad()`` used outside a
recording scope builds no graph (PyTorch alone would record it).

Shape and type inference (:meth:`Op.infer`, the reference's
``jax.eval_shape``) runs ``fn`` on tensors of the ``meta`` device, which
carry a shape and a dtype and no data; the kernels' wrappers answer them
with empty outputs of the checked shape.  An op's ``aux_update`` is the
functional form of the reference's ``FMutateInputs``: the symbolic
executor commits what it returns after a training forward.

The reference's eager jit cache (``_EAGER_JIT``) has no counterpart:
PyTorch runs eagerly.  An op flagged ``no_trace`` (an output shape that
depends on the data, ``_np_unique``) runs on real tensors only:
:meth:`Op.infer` refuses it.

``AMP_POLICY`` is ``contrib.amp``'s cast policy: while it is active,
:func:`amp_cast_inputs` casts the floating inputs of the ops it lists to
the low-precision type or to float32, and every dispatch point of the
port applies it per call: :func:`invoke` (``mx.nd``), ``gluon.block.F``
(``hybrid_forward`` on tensors) and the symbolic executor's walk
(``symbol._eval_node``).  Parameters stay float32; their gradients
reach them through the cast.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Sequence

import torch

from .. import context

__all__ = ["Op", "register", "alias", "get_op", "invoke", "OPS", "AMP_POLICY",
           "amp_cast_inputs", "list_ops", "op_info", "op_doc"]

OPS: Dict[str, "Op"] = {}


class Op:
    """A registered operator.

    fn : callable(*tensors, **attrs) -> tensor or tuple of tensors
    num_inputs : int or None (variadic)
    num_outputs : int
    differentiable : False never records (argmax, comparisons, init ops)
    aux_update : callable(in_vals, out_vals, **attrs) -> {input_idx:
        new_val} or None: the new values of the mutated inputs after a
        training forward (BatchNorm's running stats)
    mutate_idx : the positions of those inputs (``FMutateInputs``)
    no_trace : the output's shape depends on the data, so ``infer``
        refuses the op
    """

    def __init__(self, name, fn, num_inputs=None, num_outputs=1,
                 differentiable=True, aliases=(), doc="", aux_update=None,
                 mutate_idx=(), no_trace=False):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.aliases = tuple(aliases)
        self.doc = doc or (fn.__doc__ or "")
        self.aux_update = aux_update
        self.mutate_idx = tuple(mutate_idx)
        self.no_trace = no_trace

    def __repr__(self):
        return "Op(%s)" % self.name

    def infer(self, in_metas: Sequence[Any], **attrs):
        """The outputs of ``fn`` on ``meta`` tensors (None for an absent
        optional input), as a tuple of ``meta`` tensors: their shapes and
        dtypes.  An op without tensor inputs that takes ``ctx`` builds
        its output on the CPU, which is then dropped to ``meta``."""
        if self.no_trace:
            raise TypeError(
                "operator %r has a data-dependent output shape: it runs on "
                "arrays only, and its shapes cannot be inferred" % self.name)
        if not in_metas and "ctx" in inspect.signature(self.fn).parameters:
            attrs = dict(attrs, ctx="cpu")
        with torch.no_grad():
            out = self.fn(*in_metas, **attrs)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        return tuple(o.to("meta") for o in outs)


def register(name, fn=None, **kwargs):
    """Register an op (decorator or direct).  ``aliases`` adds names."""
    def _do(f):
        op = Op(name, f, **kwargs)
        OPS[name] = op
        for a in op.aliases:
            OPS[a] = op
        return f

    if fn is not None:
        return _do(fn)
    return _do


def alias(new_name, existing):
    """Register ``new_name`` as another name of the op ``existing`` and
    record it on the op (the reference's ``parity_tail._alias``)."""
    op = OPS[existing]
    OPS[new_name] = op
    if new_name not in op.aliases:
        op.aliases = op.aliases + (new_name,)


def get_op(name: str) -> Op:
    try:
        return OPS[name]
    except KeyError:
        raise NotImplementedError(
            "operator %r is not registered in the port" % name) from None


def list_ops():
    """Every registered name, aliases included, sorted."""
    return sorted(OPS.keys())


def _dmlc_type_name(default):
    """A Python default as a ``dmlc::Parameter`` field-type name."""
    if isinstance(default, bool):
        return "boolean"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, str):
        return "string"
    if isinstance(default, (tuple, list)):
        return "Shape(tuple)"
    if default is None:
        return "string or None"
    return type(default).__name__


def op_info(name):
    """An op's ``dmlc::Parameter``-style schema, from the signature of its
    ``fn`` (the reference's ``op_info``): name, description, inputs
    [(name, type)], arguments [(name, type, default repr or None)],
    num_outputs and aliases.  Which parameters are tensor inputs is the
    symbol layer's rule, so composition and reflection agree."""
    from ..symbol.symbol import _input_arg_names

    op = get_op(name)
    in_names = _input_arg_names(op)
    inputs, arguments = [], []
    for p in inspect.signature(op.fn).parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            inputs.append((p.name, "NDArray[]"))
        elif p.kind == p.VAR_KEYWORD:
            continue
        elif in_names is not None and p.name in in_names:
            inputs.append((p.name, "NDArray" if p.default is p.empty
                           else "NDArray, optional"))
        elif p.default is p.empty:
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                inputs.append((p.name, "NDArray"))
            else:
                arguments.append((p.name, "required", None))
        else:
            arguments.append((p.name, "%s, optional"
                              % _dmlc_type_name(p.default), repr(p.default)))
    return {"name": op.name, "description": (op.doc or "").strip(),
            "inputs": inputs, "arguments": arguments,
            "num_outputs": op.num_outputs, "aliases": list(op.aliases)}


def op_doc(name):
    """``op_info`` rendered as the reference's docstring text."""
    info = op_info(name)
    lines = [info["name"], ""]
    if info["description"]:
        lines += [info["description"], ""]
    if info["inputs"]:
        lines.append("Inputs:")
        lines += ["    %s : %s" % (n, t) for n, t in info["inputs"]]
        lines.append("")
    if info["arguments"]:
        lines.append("Parameters:")
        lines += ["    %s : %s%s" % (n, t, "" if d is None
                                      else ", default=%s" % d)
                  for n, t, d in info["arguments"]]
    return "\n".join(lines)


# contrib.amp's cast policy (the reference's ops/registry.py AMP_POLICY):
# ``lo`` names the ops whose floating inputs go to ``target``, ``hi``
# those that go to float32, ``cond`` {op: (attr, values)} the ops that go
# to float32 when an attribute takes one of the values
AMP_POLICY: Dict[str, Any] = {"active": False, "target": None,
                              "lo": frozenset(), "hi": frozenset(),
                              "cond": {}}


def _amp_target(name, attrs):
    cond = AMP_POLICY["cond"].get(name)
    if cond is not None and attrs is not None \
            and str(attrs.get(cond[0])) in cond[1]:
        return torch.float32
    if name in AMP_POLICY["lo"]:
        return AMP_POLICY["target"]
    if name in AMP_POLICY["hi"]:
        return torch.float32
    return None


def amp_cast_inputs(op, arrays, attrs=None):
    """``arrays`` with each floating tensor cast as the active AMP policy
    says for ``op`` (an :class:`Op` or an op name): to the target type
    for a listed low-precision op, to float32 for a listed float32 op or
    a conditional one whose attribute matches (softrelu ``Activation``).
    Integer tensors (indices, masks), ``None`` and scalars pass as they
    are; so does everything while the policy is off."""
    if not AMP_POLICY["active"]:
        return arrays
    tgt = _amp_target(op if isinstance(op, str) else op.name, attrs)
    if tgt is None:
        return arrays
    return [a.to(tgt) if isinstance(a, torch.Tensor)
            and a.is_floating_point() and a.dtype != tgt else a
            for a in arrays]


def _device_of(inputs):
    """The first NDArray input's device; the default card when the only
    inputs are scalars or numpy arrays (None when there is no input)."""
    from ..ndarray import NDArray

    for i in inputs:
        if isinstance(i, NDArray):
            return i._data.device
    if any(i is not None for i in inputs):
        return context.resolve(None)
    return None


def invoke(name: str, inputs: Sequence[Any], out=None, **attrs):
    """Run op ``name`` on NDArrays (``Imperative::Invoke``): returns an
    NDArray, or a list of them for a multi-output op.  ``out`` (an NDArray
    or a list of them) receives the outputs instead (kWriteTo): fewer
    buffers than outputs drops the trailing outputs, more raises."""
    from .. import autograd
    from ..ndarray import NDArray

    op = get_op(name)
    device = _device_of(inputs)
    datas = [None if i is None
             else i._data if isinstance(i, NDArray)
             else torch.as_tensor(i, device=device)
             for i in inputs]
    recording = (autograd.is_recording() and op.differentiable
                 and any(autograd.requires_grad(i) for i in inputs
                         if isinstance(i, NDArray)))
    with torch.set_grad_enabled(recording):
        res = op.fn(*amp_cast_inputs(op, datas, attrs), **attrs)
    multi = isinstance(res, (tuple, list))
    # outside a recording a result is a constant: a view op under no_grad
    # would otherwise inherit requires_grad from a variable it views
    nd_outs = [NDArray(t if recording else t.detach())
               for t in (res if multi else [res])]
    if out is not None:
        outs = out if isinstance(out, (tuple, list)) else [out]
        if len(outs) > len(nd_outs):
            raise ValueError(
                "op %r produced %d output(s) but %d output buffer(s) were "
                "provided" % (name, len(nd_outs), len(outs)))
        for dst, src in zip(outs, nd_outs):
            dst._set_data(src._data)
        return out
    return nd_outs if multi else nd_outs[0]
