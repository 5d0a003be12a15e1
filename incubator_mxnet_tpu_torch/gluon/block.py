"""Gluon ``Block`` and ``HybridBlock`` over ``torch.nn.Module`` (port of
``incubator_mxnet_tpu/gluon/block.py``), with deferred shapes and the
tensor-op namespace ``F`` of the port's layers.

A ``Block`` is an ``nn.Module`` with the reference's names: a prefix from
the reference's name scopes (``conv2d0_``, ``dense1_``, or the parent's
prefix inside ``with self.name_scope():``), ``params`` (its
:class:`ParameterDict`), ``collect_params``, ``initialize``, ``cast``,
``hybridize``, ``save_parameters``/``load_parameters`` (structural
names, ``features.0.weight``, the reference's file format) and
``summary``.  Assigning a :class:`Parameter` to an attribute registers
its tensor with PyTorch under that name, so ``named_parameters()`` and
``named_buffers()`` list what ``collect_params()`` lists.

Two ways to call a block:

- on ``torch.Tensor`` inputs it is a plain ``nn.Module``: ``forward``
  runs on tensors, train mode is ``module.train()``/``eval()`` (this is
  what ``TrainStep`` calls);
- on ``NDArray`` inputs (the reference's way), a ``HybridBlock`` runs
  the same forward on the arrays' tensors with grad mode on only inside
  ``autograd.record()`` and train mode from ``autograd.is_training()``
  (BN batch statistics and Dropout inside ``record()``, inference
  outside), and returns NDArrays whose ``backward()`` fills every
  ``Parameter.grad()``.

- on :class:`..symbol.Symbol` inputs (or a tuple whose first element is
  one: a dual ghost-BN exit hands on ``(out, out_sc)``), a
  ``HybridBlock`` composes a graph: ``hybrid_forward(mx.sym, x,
  **params)`` with each parameter's ``Parameter.var()``, children
  recursing the same way.  This is what :meth:`HybridBlock.export`
  traces.

``hybridize`` runs eagerly: the CUDA-graph analogue of the reference's
cached program is ROADMAP A5f.  A user ``HybridBlock`` implements
``hybrid_forward(F, x, **params)``: ``F`` is the port's ops on tensors
(the registered ops by name, and ``FullyConnected`` and ``Activation``
in the reference's keywords),
``params`` its registered parameters' tensors; on symbols ``F`` is
``mx.sym``.  A port layer's ``hybrid_forward`` is the reference layer's
(the same registry ops, names, attributes and input order): its
symbolic body, and its tensor one unless the layer has a ``forward`` of
its own (``BatchNorm``, ``Dropout`` and the ghost-BN layers, which read
the module's train mode and commit running stats).

A layer given no input width (``in_channels=0``, ``in_units=0``) creates
its tensors as ``torch.nn.UninitializedParameter`` /
``UninitializedBuffer`` and resolves them from its first input
(PyTorch's ``LazyModuleMixin``, :class:`Deferred`), as the reference
resolves deferred parameters; :func:`shape_init` resolves every such
layer of a net at once.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import is_lazy

from .. import autograd, context, symbol
from ..ndarray import NDArray
from ..symbol.symbol import Symbol, _eval_graph
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Deferred", "shape_init",
           "F"]


class _BlockScope:
    """Name scoping for automatic prefixes: a global counter per hint
    (``conv2d0_``) outside any scope, one per parent inside its
    ``name_scope()``."""

    _state = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def current():
        return getattr(_BlockScope._state, "value", None)

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                if not hasattr(_BlockScope._state, "counter"):
                    _BlockScope._state.counter = {}
                count = _BlockScope._state.counter.get(hint, 0)
                prefix = "%s%d_" % (hint, count)
                _BlockScope._state.counter[hint] = count + 1
            return prefix, ParameterDict(prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        parent = current._block
        full_prefix = parent.prefix + prefix
        return full_prefix, ParameterDict(
            full_prefix, params if params is not None
            else parent._params._shared)

    def __enter__(self):
        self._old_scope = _BlockScope.current()
        _BlockScope._state.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._state.value = self._old_scope


def _is_nd(v):
    return isinstance(v, NDArray) or (
        isinstance(v, (tuple, list)) and any(_is_nd(i) for i in v))


def _to_tensors(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (tuple, list)):
        return type(v)(_to_tensors(i) for i in v)
    return v


def _is_symbol(v):
    if isinstance(v, tuple) and v:
        v = v[0]
    return isinstance(v, Symbol)


def _to_nds(v):
    if isinstance(v, torch.Tensor):
        return NDArray(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_to_nds(i) for i in v)
    return v


class Block(nn.Module):
    """Base building block: an ``nn.Module`` with the reference's prefix,
    parameters and persistence."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    @property
    def _children(self):
        return {k: m for k, m in self._modules.items()
                if isinstance(m, Block)}

    def name_scope(self):
        return self._scope

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is None:
                raise AttributeError("assign parameters after "
                                     "Block.__init__")
            reg[name] = value
            t = value._ensure_tensor(self.__dict__.get("_device"))
            self._parameters.pop(name, None)
            self._buffers.pop(name, None)
            if value._buffer:
                self.register_buffer(name, t)
            else:
                self.register_parameter(name, t)
            return
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters, optionally those
        whose names match the regular expression ``select``."""
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select is not None else None
        ret.update({k: v for k, v in self._params.items()
                    if pattern is None or pattern.match(k)})
        for p in self._reg_params.values():
            if pattern is None or pattern.match(p.name):
                ret._params.setdefault(p.name, p)
        for child in self._children.values():
            ret.update(child.collect_params(select)._params)
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (``ParameterDict.initialize``)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """A no-op that recurses into the children: the port runs every
        block eagerly (a CUDA-graph form is ROADMAP A5f)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def _collect_params_with_prefix(self, prefix=""):
        """Structural parameter names (``features.0.weight``), stable
        across nets of one structure: the names of ``.params`` files."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for cname, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + cname))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        from ..ndarray import save as nd_save

        nd_save(filename, {name: p.data() for name, p in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``.params`` file saved by ``save_parameters`` of either
        package (structural names), or one keyed by full names."""
        from .. import context
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=context.cpu())
        params = self._collect_params_with_prefix()
        if loaded and params and not any(k in params for k in loaded):
            by_name = {p.name: p for p in params.values()}
            params = {k: by_name[k] for k in loaded if k in by_name}
        for name, p in params.items():
            if name in loaded:
                if cast_dtype and dtype_source == "saved":
                    p.cast(loaded[name].dtype)
                p.set_data(loaded[name])
            elif not allow_missing:
                raise RuntimeError("Parameter %s is missing in file %s"
                                   % (name, filename))
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise RuntimeError("Parameters in file not in Block: %s"
                                   % sorted(extra))

    save_params = save_parameters
    load_params = load_parameters

    def summary(self, *inputs):
        lines = ["%s summary:" % self.name]
        for name, p in self.collect_params().items():
            lines.append("  %-40s %s" % (name, p.shape))
        s = "\n".join(lines)
        print(s)
        return s


class HybridBlock(Block):
    """A block whose forward runs on tensors: ``forward`` of a port
    layer, or ``hybrid_forward(F, x, **params)`` of a user subclass.
    Called on NDArrays, it returns NDArrays recorded on the port's
    autograd (see the module docstring)."""

    def __call__(self, *args, **kwargs):
        if args and _is_symbol(args[0]):
            return self._compose(*args, **kwargs)
        if not (_is_nd(args) or _is_nd(tuple(kwargs.values()))):
            return super().__call__(*args, **kwargs)
        return self._on_tensors(super().__call__, args, kwargs)

    def _compose(self, x, *args, **kwargs):
        """The symbolic route: ``hybrid_forward`` with ``F = mx.sym`` and
        the parameters' variables."""
        params = {name: p.var() for name, p in self._reg_params.items()}
        return self.hybrid_forward(symbol, x, *args, **kwargs, **params)

    def _on_tensors(self, fn, args, kwargs):
        """``fn`` (this block's work on tensors) on the tensors of NDArray
        arguments, with grad mode on only inside ``autograd.record()``
        and train mode from ``autograd.is_training()``; its tensors come
        back as NDArrays."""
        training = autograd.is_training()
        was = self.training
        if was != training:
            self.train(training)
        try:
            with torch.set_grad_enabled(autograd.is_recording()):
                out = fn(*_to_tensors(args),
                         **{k: _to_tensors(v) for k, v in kwargs.items()})
        finally:
            if was != training:
                self.train(was)
        return _to_nds(out)

    def forward(self, x, *args, **kwargs):
        params = {name: getattr(self, name) for name in self._reg_params}
        return self.hybrid_forward(F, x, *args, **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):  # noqa: N803
        raise NotImplementedError

    def shape_init(self, *input_shapes, dtype="float32"):
        """Resolve deferred shapes at ``input_shapes`` (see
        :func:`shape_init`)."""
        from ..base import torch_dtype

        return shape_init(self, *input_shapes, dtype=torch_dtype(dtype))

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` (the graph traced from
        ``sym.var("data")``) and ``path-%04d.params`` (every parameter, as
        ``arg:`` or ``aux:`` by the graph's auxiliary states), the files
        ``model.load_checkpoint`` and ``SymbolBlock.imports`` read.
        Returns their names."""
        from ..ndarray import save as nd_save

        out = self(symbol.var("data"))
        out.save("%s-symbol.json" % path)
        aux_names = set(out.list_auxiliary_states())
        nd_save("%s-%04d.params" % (path, epoch), {
            ("aux:" if name in aux_names else "arg:") + name: p.data()
            for name, p in self.collect_params().items()})
        return "%s-symbol.json" % path, "%s-%04d.params" % (path, epoch)


class SymbolBlock(HybridBlock):
    """A graph and its parameters as a block (the reference's
    ``SymbolBlock``).

    Every input of ``outputs`` that is not one of ``inputs`` becomes a
    parameter of that name: an argument with a gradient, or an auxiliary
    state (a running statistic) held as a buffer without one.  The
    forward walks the graph as ``Symbol.eval_with`` does, in training
    mode from ``autograd.is_training()`` (the module's mode when called
    on tensors), and commits no running stat, as the reference's
    ``_eval_graph`` commits none.  Shapes not given by a file are
    inferred from the first input."""

    def __init__(self, outputs, inputs, params=None, device=None):
        super().__init__(prefix="", params=params)
        if isinstance(outputs, (list, tuple)):
            outputs = symbol.Group(outputs)
        self._device = context.resolve(device)
        self._out_sym = outputs
        self._in_syms = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        in_names = {s.name for s in self._in_syms}
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_inputs():
            if name in in_names:
                continue
            p = self.params.get(name, allow_deferred_init=True,
                                grad_req="null" if name in aux else "write",
                                buffer=name in aux)
            self._reg_params[name] = p
            t = p._ensure_tensor(self._device)
            safe = name.replace(".", "_")
            if p._buffer:
                self.register_buffer(safe, t)
            else:
                self.register_parameter(safe, t)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A ``SymbolBlock`` of ``symbol_file`` over the named inputs, its
        parameters loaded from ``param_file`` (``arg:``/``aux:`` keys or
        plain names), on ``ctx`` (``None``: the card)."""
        from ..ndarray import load as nd_load

        out = symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(out, [symbol.var(n) for n in input_names],
                            device=ctx)
        if param_file:
            for k, v in nd_load(param_file, ctx=context.cpu()).items():
                name = k.split(":", 1)[-1]
                if name in block.params:
                    block.params[name].set_data(v)
        return block

    def _infer_params(self, xs):
        """Materialize the parameters whose shapes wait for the input."""
        lazy = {n: p for n, p in self._reg_params.items()
                if is_lazy(p._tensor)}
        if not lazy:
            return
        arg_shapes, _, aux_shapes = self._out_sym.infer_shape(**{
            s.name: tuple(x.shape) for s, x in zip(self._in_syms, xs)})
        shapes = dict(zip(self._out_sym.list_arguments(), arg_shapes))
        shapes.update(zip(self._out_sym.list_auxiliary_states(),
                          aux_shapes))
        with torch.no_grad():
            for name, p in lazy.items():
                p._tensor.materialize(shapes[name])
                p._materialized(name)

    def forward(self, *args):
        self._infer_params(args)
        bindings = {s.name: a for s, a in zip(self._in_syms, args)}
        bindings.update({n: p._tensor for n, p in self._reg_params.items()})
        with autograd._scope(training=self.training):
            outs = _eval_graph(self._out_sym, bindings, args[0].device)
        return outs[0] if len(outs) == 1 else outs


class Deferred(LazyModuleMixin):
    """Mixin of a layer whose tensor shapes may wait for its input.

    The layer makes its parameters with ``self.params.get`` (a 0 in a
    shape: deferred) and implements ``_infer_shapes(x)``, returning
    ``{name: shape}``.  On the first forward the deferred tensors are
    materialized and each ``Parameter`` finishes: the initializer that
    ``initialize`` left runs, or the pending one of
    :func:`initializer.initialize`, or its constant default (BN's ones
    and zeros)."""

    def initialize_parameters(self, x, *args, **kwargs):
        if not self.has_uninitialized_params():
            return
        shapes = self._infer_shapes(x)
        made = []
        with torch.no_grad():
            for kind in (self._parameters, self._buffers):
                for name, t in kind.items():
                    if t is not None and is_lazy(t):
                        t.materialize(shapes[name])
                        made.append(name)
        pending = self.__dict__.pop("_pending_init", None)
        with torch.no_grad():
            for name in made:
                self._reg_params[name]._materialized(name, pending)


def shape_init(net, *input_shapes, dtype=torch.float32):
    """Resolve the deferred shapes of ``net`` (``Block.shape_init``): one
    forward in inference mode, without gradients, of zeros of the given
    shapes with the leading (batch) axis cut to 1, on the device of the
    net's first tensor.  No running stat is touched; a pending
    initializer (``initialize`` run before) fills the resolved tensors.
    Returns ``net``."""
    tensors = list(net.parameters()) + list(net.buffers())
    device = tensors[0].device if tensors else torch.device("cpu")
    xs = [torch.zeros((1,) + tuple(s)[1:], dtype=dtype, device=device)
          for s in input_shapes]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*xs)
    finally:
        net.train(was_training)
    return net


class _TensorOps:
    """``F`` of ``hybrid_forward`` and ``HybridLambda``: the registered
    ops of the port (``ops/math.py``, ``ops/tensor.py``, ``ops/nn.py``'s
    forms) by name, on tensors (``F.clip(x, 0, 6)``, ``F.Concat(a, b,
    dim=1)``, ``F.FullyConnected(x, w, b, num_hidden=10)``); ``F.contrib``
    the ``_contrib_`` ones (``F.contrib.DeformableConvolution``).  Each
    call applies ``contrib.amp``'s cast policy as it stands at that call
    (``registry.amp_cast_inputs``), so a policy turned on after a net
    first ran is seen."""

    def __init__(self, prefix=""):
        self._prefix = prefix

    def __getattr__(self, name):
        from ..ops import math, nn, registry, tensor  # noqa: F401  (registers)

        if name.startswith("__") or name == "_prefix":
            raise AttributeError(name)
        if name == "contrib" and not self._prefix:
            fn = _TensorOps("_contrib_")
        else:
            fn = _amp_dispatch(registry.get_op(self._prefix + name))
        setattr(self, name, fn)  # the next lookup skips this
        return fn


def _amp_dispatch(op):
    """``op.fn`` with its inputs cast by the AMP policy of the moment."""
    from ..ops.registry import amp_cast_inputs

    def call(*args, **kwargs):
        return op.fn(*amp_cast_inputs(op, args, kwargs), **kwargs)

    call.__name__ = op.name
    call.__doc__ = op.doc
    return call


F = _TensorOps()
