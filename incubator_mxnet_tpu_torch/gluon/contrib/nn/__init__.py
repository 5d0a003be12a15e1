"""``mx.gluon.contrib.nn`` (port of
``incubator_mxnet_tpu/gluon/contrib/nn/__init__.py``): the
mixture-of-experts layer ``MoEFFN``.  The file's other blocks
(``PixelShuffle*``, ``Concurrent``, ``SyncBatchNorm`` and the rest) are
ROADMAP A13."""
from __future__ import annotations

from .... import context, tracing
from ....parallel import collectives
from ....parallel.mesh import P
from ....parallel.moe import (dp_load_balancing_loss, load_balancing_loss,
                              moe_ffn_local)
from ...block import Deferred, HybridBlock

__all__ = ["MoEFFN"]


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
