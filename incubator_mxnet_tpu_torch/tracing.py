"""The trace context of a training forward (the aux-loss part of
``incubator_mxnet_tpu/tracing.py``).

``TrainStep`` pushes a :class:`TraceContext` around the forward of each
step; a block reads it with :func:`current_trace`.  A block that computes
an auxiliary loss (``gluon.contrib.nn.MoEFFN``'s load balancing)
registers it with :meth:`TraceContext.add_aux_loss`, and the step adds
every registered loss to the task loss in f32, before the loss scale.
The context also tells a block which of its parameters the step hands it
as this rank's shards (``local_shards``) over which ``mesh``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

__all__ = ["TraceContext", "current_trace", "push_trace", "pop_trace"]

_STATE = threading.local()


class TraceContext:
    """One forward's context: ``training``, the ``aux_losses`` registered
    during it, the step's ``mesh`` and ``local_shards`` (``{id(block):
    axis name}`` for a block whose sharded parameters it receives as
    this rank's shards)."""

    def __init__(self, training: bool = True, mesh=None,
                 local_shards: Optional[Dict[int, str]] = None):
        self.training = training
        self.mesh = mesh
        self.local_shards = dict(local_shards or {})
        self.aux_losses: List[Any] = []

    def add_aux_loss(self, value, source=None):
        """Register a scalar auxiliary loss (an MoE load-balancing term)
        to be added to the training objective by the enclosing step.
        ``source`` names the registering block for error messages."""
        shape = tuple(getattr(value, "shape", ()) or ())
        if shape != ():
            who = " registered by %s" % source if source else ""
            raise ValueError(
                "aux loss%s must be a scalar, got shape %s — a vector "
                "aux loss silently corrupts the training objective when "
                "the fused step sums it into the (scalar) task loss; "
                "reduce it first (e.g. .mean() or .sum())" % (who, shape))
        self.aux_losses.append(value)


def _stack() -> List[TraceContext]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def current_trace() -> Optional[TraceContext]:
    s = _stack()
    return s[-1] if s else None


def push_trace(ctx: TraceContext) -> TraceContext:
    _stack().append(ctx)
    return ctx


def pop_trace() -> TraceContext:
    return _stack().pop()
