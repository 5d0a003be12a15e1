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
PyTorch runs eagerly.  Its AMP input casts (``_amp_cast_inputs``) wait for
the port's AMP (ROADMAP A13).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Sequence

import torch

from .. import context

__all__ = ["Op", "register", "get_op", "invoke", "OPS"]

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
    """

    def __init__(self, name, fn, num_inputs=None, num_outputs=1,
                 differentiable=True, aliases=(), doc="", aux_update=None,
                 mutate_idx=()):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.aliases = tuple(aliases)
        self.doc = doc or (fn.__doc__ or "")
        self.aux_update = aux_update
        self.mutate_idx = tuple(mutate_idx)

    def __repr__(self):
        return "Op(%s)" % self.name

    def infer(self, in_metas: Sequence[Any], **attrs):
        """The outputs of ``fn`` on ``meta`` tensors (None for an absent
        optional input), as a tuple of ``meta`` tensors: their shapes and
        dtypes.  An op without tensor inputs that takes ``ctx`` builds
        its output on the CPU, which is then dropped to ``meta``."""
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


def get_op(name: str) -> Op:
    try:
        return OPS[name]
    except KeyError:
        raise NotImplementedError(
            "operator %r is not registered in the port" % name) from None


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
        res = op.fn(*datas, **attrs)
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
