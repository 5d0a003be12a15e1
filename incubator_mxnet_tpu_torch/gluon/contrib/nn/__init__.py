"""``mx.gluon.contrib.nn`` (port of
``incubator_mxnet_tpu/gluon/contrib/nn/__init__.py``): ``Concurrent``,
``HybridConcurrent``, ``Identity``, ``SparseEmbedding``,
``SyncBatchNorm``, ``PixelShuffle1D``/``2D``/``3D`` and the
mixture-of-experts layer ``MoEFFN``.

As in the reference, ``HybridConcurrent``, ``Identity``,
``SparseEmbedding`` and ``SyncBatchNorm`` compose on symbols and the
pixel shuffles and ``MoEFFN`` do not (the reference's shuffles read the
input's shape, which a symbol lacks).
"""
from __future__ import annotations

import torch

from .... import context, tracing
from ....ndarray import NDArray
from ....ndarray import ndarray as _nd
from ....parallel import collectives
from ....parallel.mesh import P
from ....parallel.moe import (dp_load_balancing_loss, load_balancing_loss,
                              moe_ffn_local)
from ...block import Deferred, HybridBlock
from ...nn import BatchNorm, Embedding, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D", "MoEFFN"]


class Concurrent(Sequential):
    """Every child on the same input, their outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        outs = [child(x) for child in self._children.values()]
        if isinstance(outs[0], NDArray):
            return _nd.concat(*outs, dim=self.axis)
        return torch.cat(outs, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """``Concurrent`` as a ``HybridBlock``."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.concat(*[child(x) for child in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """The input, unchanged (a ``Concurrent`` branch)."""

    def hybrid_forward(self, F, x):  # noqa: N803
        return x


class SparseEmbedding(Embedding):
    """``Embedding`` under the reference's contrib name.  The reference's
    gradient is a ``row_sparse`` one that updates the rows looked up; as
    in the JAX package, the gradient here is dense (the rows not looked up
    get zeros)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer, **kwargs)


class SyncBatchNorm(BatchNorm):
    """Batch norm with the statistics of the whole data-parallel batch.
    The port's ``BatchNorm`` already takes them over the dp axis inside a
    data-parallel step (``ops.nn._SyncBatchNorm`` under
    ``collectives.dp_scope``); in one process it is ``BatchNorm``.
    ``num_devices`` and ``key`` are the reference's arguments, kept."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, key=None, **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices
        self._key = key


class _PixelShuffle(HybridBlock):
    """Splits the factors off the channel axis and interleaves them into
    the spatial axes: (N, C * prod(f), *S) to (N, C, *(S * f))."""

    def __init__(self, factor, ndim):
        super().__init__()
        if isinstance(factor, int):
            factor = (factor,) * ndim
        self._factors = tuple(int(f) for f in factor)
        if len(self._factors) != ndim:
            raise ValueError("factor must be an int or a %d-tuple" % ndim)

    def forward(self, x):
        fs = self._factors
        k = len(fs)
        n, c = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        cout = c
        for f in fs:
            if cout % f:
                raise ValueError(
                    "channel dim %d not divisible by factor %d" % (c, f))
            cout //= f
        y = x.reshape((n, cout) + fs + spatial)
        perm = [0, 1]
        for i in range(k):
            perm.extend([2 + k + i, 2 + i])
        y = y.permute(perm)
        return y.reshape((n, cout) + tuple(s * f for s, f in
                                           zip(spatial, fs)))

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._factors)


class PixelShuffle1D(_PixelShuffle):
    """(N, f*C, W) to (N, C, f*W)."""

    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    """(N, f1*f2*C, H, W) to (N, C, f1*H, f2*W)."""

    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    """(N, f1*f2*f3*C, D, H, W) to (N, C, f1*D, f2*H, f3*W)."""

    def __init__(self, factor):
        super().__init__(factor, 3)


class MoEFFN(Deferred, HybridBlock):
    """Mixture-of-experts FFN layer (token-choice, top-k router) over
    :func:`~incubator_mxnet_tpu_torch.parallel.moe.moe_ffn`: gate_weight
    (in_units, E), expert_w1 (E, in_units, hidden), expert_b1 (E,
    hidden), expert_w2 (E, hidden, in_units), expert_b2 (E, in_units);
    ``in_units`` 0 defers to the first input.

    In a training step's forward (a training ``TraceContext``) the
    load-balancing loss, times ``aux_loss_weight``, is registered on the
    context and added to the objective by the step; over a data-parallel
    mesh it is the global batch's, as is the capacity.  When the step
    shards the expert parameters over an axis (``param_shardings=
    block.expert_shardings("ep")``) the block is handed this rank's
    experts and runs them alone, one ``allreduce`` over the axis summing
    the combine (:func:`~incubator_mxnet_tpu_torch.parallel.moe.
    moe_ffn_local`)."""

    #: the train step hands a sharded expert parameter to this block as
    #: this rank's shard, not gathered
    takes_shards = True

    def __init__(self, hidden_size, num_experts, top_k=1,
                 capacity_factor=None, aux_loss_weight=1e-2, in_units=0,
                 dtype="float32", device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._hidden = hidden_size
        self._num_experts = num_experts
        self._top_k = top_k
        self._capacity_factor = capacity_factor
        self._aux_loss_weight = aux_loss_weight
        e, d, h = num_experts, in_units, hidden_size
        with self.name_scope():
            self.gate_weight = self.params.get(
                "gate_weight", shape=(d, e), dtype=dtype,
                allow_deferred_init=True)
            self.expert_w1 = self.params.get(
                "expert_w1", shape=(e, d, h), dtype=dtype,
                allow_deferred_init=True)
            self.expert_b1 = self.params.get(
                "expert_b1", shape=(e, h), dtype=dtype, init="zeros")
            self.expert_w2 = self.params.get(
                "expert_w2", shape=(e, h, d), dtype=dtype,
                allow_deferred_init=True)
            self.expert_b2 = self.params.get(
                "expert_b2", shape=(e, d), dtype=dtype, init="zeros",
                allow_deferred_init=True)

    def _infer_shapes(self, x):
        d = x.shape[-1]
        e, h = self._num_experts, self._hidden
        return {"gate_weight": (d, e), "expert_w1": (e, d, h),
                "expert_w2": (e, h, d), "expert_b2": (e, d)}

    def expert_shardings(self, axis_name="ep"):
        """``param_shardings`` entries placing the expert dim on
        ``axis_name`` (the gate stays replicated): pass them to
        ``make_train_step``."""
        reg = self._reg_params
        return {reg["expert_w1"].name: P(axis_name, None, None),
                reg["expert_b1"].name: P(axis_name, None),
                reg["expert_w2"].name: P(axis_name, None, None),
                reg["expert_b2"].name: P(axis_name, None)}

    def forward(self, x):
        lead = x.shape[:-1]
        tokens = x.reshape(-1, x.shape[-1])
        tc = tracing.current_trace()
        axis = tc.local_shards.get(id(self)) if tc is not None else None
        experts = (self.expert_w1, self.expert_b1, self.expert_w2,
                   self.expert_b2)
        if axis is not None and \
                experts[0].shape[0] * tc.mesh.shape[axis] != \
                self._num_experts:
            raise ValueError(
                "%s: handed %d of %d experts on %s=%d"
                % (self.name, experts[0].shape[0], self._num_experts, axis,
                   tc.mesh.shape[axis]))
        dp = collectives.current_dp()
        out, probs, top_idx = moe_ffn_local(
            tokens, self.gate_weight, *experts, top_k=self._top_k,
            capacity_factor=self._capacity_factor, axis_name=axis,
            mesh=tc.mesh if axis is not None else None, dp=dp)
        if tc is not None and tc.training and self._aux_loss_weight:
            aux = load_balancing_loss(probs, top_idx) if dp is None \
                else dp_load_balancing_loss(probs, top_idx, dp)
            tc.add_aux_loss(self._aux_loss_weight * aux,
                            source="MoEFFN(%s)" % self.name)
        return out.reshape(tuple(lead) + (out.shape[-1],))

    def hybrid_forward(self, F, x, *args, **kwargs):  # noqa: N803
        raise NotImplementedError(
            "MoEFFN has no symbolic (Symbol) path; train it through the "
            "fused train step")
