"""Deferred shapes and the tensor-op namespace of the port's layers (the
parts of ``incubator_mxnet_tpu/gluon/block.py`` that its layers use).

A layer given no input width (``in_channels=0``, ``in_units=0``) creates
its tensors as ``torch.nn.UninitializedParameter`` /
``UninitializedBuffer`` on its device and resolves them from the first
input it sees (PyTorch's ``LazyModuleMixin``), as the reference resolves
deferred parameters.  :func:`initializer.initialize` run before that
leaves such a layer a pending initializer, applied when its shapes are
known; :func:`shape_init` resolves every such layer of a net at once.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import is_lazy

__all__ = ["Deferred", "shape_init", "F"]


class Deferred(LazyModuleMixin):
    """Mixin of a layer whose tensor shapes may wait for its input.

    The layer declares its tensors with :meth:`_param` / :meth:`_buffer`
    (``shape`` None: deferred) and implements ``_infer_shapes(x)``,
    returning ``{name: shape}``.  On the first forward the deferred
    tensors are materialized with their ``fill`` (the layer's default
    initializer: BN's ones and zeros) and, where
    :func:`initializer.initialize` left one, the pending initializer
    fills them."""

    def _param(self, name, shape, device, fill=None, trainable=True):
        if shape is None:
            p = nn.UninitializedParameter(device=device,
                                          requires_grad=trainable)
            self._fill_later(name, fill)
        else:
            t = torch.empty(shape, device=device)
            if fill is not None:
                t.fill_(fill)
            p = nn.Parameter(t, requires_grad=trainable)
        self.register_parameter(name, p)

    def _buffer(self, name, shape, device, fill):
        if shape is None:
            self.register_buffer(name, nn.UninitializedBuffer(device=device))
            self._fill_later(name, fill)
        else:
            self.register_buffer(name, torch.full(shape, float(fill),
                                                  device=device))

    def _fill_later(self, name, fill):
        if fill is not None:
            self.__dict__.setdefault("_fills", {})[name] = fill

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
                        fill = self.__dict__.get("_fills", {}).get(name)
                        if fill is not None:
                            t.fill_(fill)
                        made.append((name, t))
        pending = self.__dict__.pop("_pending_init", None)
        if pending is not None:
            init, generator = pending
            for name, t in made:
                init(name, t, generator)


def shape_init(net, *input_shapes, dtype=torch.float32):
    """Resolve the deferred shapes of ``net`` (``Block.shape_init``): one
    forward in inference mode, without gradients, of zeros of the given
    shapes with the leading (batch) axis cut to 1, on the device of the
    net's first tensor.  No running stat is touched; a pending
    initializer (``initializer.initialize`` run before) fills the
    resolved tensors.  Returns ``net``."""
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
    """``F`` of a ``HybridLambda``: the registered ops of the port
    (``ops/math.py``, ``ops/tensor.py``) by name, on tensors:
    ``F.clip(x, 0, 6)``, ``F.Concat(a, b, dim=1)``."""

    def __getattr__(self, name):
        from ..ops import math, registry, tensor  # noqa: F401  (registers)

        return registry.get_op(name).fn


F = _TensorOps()
