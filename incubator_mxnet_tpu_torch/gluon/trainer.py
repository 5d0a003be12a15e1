"""Gluon ``Trainer`` (port of ``incubator_mxnet_tpu/gluon/trainer.py``): an
optimizer over a set of ``Parameter``s.

``step(batch_size)`` reduces the gradients through the kvstore (a
``dist_*`` store with several workers sums them across the processes;
nothing to reduce in one process, unless a third-party store is plugged
in), then updates every parameter with a gradient through the optimizer's
``Updater``, one parameter at a time as the reference does, with
``rescale_grad = scale / batch_size / loss_scale``.  The update writes
into each parameter's tensor: the tensor its module computes with.

``make_fused_step(net, loss_fn, ...)`` builds the port's ``TrainStep``
from this trainer's optimizer instead: forward, backward and update in
one call over tensors.
"""
from __future__ import annotations

import copy
from typing import List

from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict or a list of "
                             "Parameters")
        self._params: List[Parameter] = []
        self._param2idx = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise ValueError("invalid parameter %r" % (p,))
            self._param2idx[p.name] = i
            self._params.append(p)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = {p.name: p for p in self._params}
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("param_dict", param_dict)
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        if self._kv_initialized:
            return
        from .. import kvstore as kv_mod

        kv = self._kvstore_type
        if kv is None or kv == "None":
            self._kvstore = None
        else:
            self._kvstore = kv_mod.create(kv) if isinstance(kv, str) else kv
        self._kv_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients, then update with them divided by
        ``batch_size``.

        With a ``LossScaler`` attached (``contrib.amp.init_trainer``) the
        gradients are also divided by the scale the loss was multiplied
        by; a non-finite gradient (checked at every scale, 1 included)
        skips the update and halves the scale."""
        self._init_kvstore()
        scaler = getattr(self, "_amp_loss_scaler", None)
        loss_scale = scaler.loss_scale if scaler is not None else 1.0
        self.allreduce_grads()
        if scaler is not None:
            if scaler.has_overflow(self._params):
                scaler.update_scale(True)
                return
            scaler.update_scale(False)
        # the scale the loss was multiplied by: update_scale may have
        # doubled it for the next step
        self.update(batch_size, ignore_stale_grad, _loss_scale=loss_scale)

    def allreduce_grads(self):
        """Reduce gradients across workers: a store with more than one
        worker, or a plugged-in store (``KVStoreBase.register``), gets a
        ``pushpull`` per parameter, in order; a ``dist`` store at one
        worker and the built-in local stores have nothing to reduce."""
        if self._kvstore is None:
            return
        from ..kvstore.kvstore import KVStore

        plugged = type(self._kvstore) is not KVStore and \
            not self._kvstore.type.startswith("dist")
        if getattr(self._kvstore, "num_workers", 1) > 1 or plugged:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.pushpull(i, p.grad(), out=p.grad())

    def update(self, batch_size, ignore_stale_grad=False, _loss_scale=None):
        if _loss_scale is None:
            scaler = getattr(self, "_amp_loss_scaler", None)
            _loss_scale = scaler.loss_scale if scaler is not None else 1.0
        self._optimizer.rescale_grad = self._scale / batch_size / _loss_scale
        updater = self._updaters[0]
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            updater(i, p.grad(), p.data())

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Load states saved by ``save_states`` of either package onto the
        device of this trainer's parameters."""
        dev = next((p.list_ctx()[0] for p in self._params), None)
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read(), ctx=dev)

    def make_fused_step(self, net, loss_fn, mesh=None, compute_dtype=None,
                        pipeline_stages=None, num_micro=1,
                        pipeline_axis="pp", pipeline_remat=False,
                        multi_precision=None, nonfinite=None,
                        loss_scale=None, device=None):
        """The port's ``TrainStep`` over ``net`` and ``loss_fn`` with this
        trainer's optimizer: forward, backward and update per call
        (``step(x, y)``), on tensors, over ``mesh`` (``pipeline_stages=
        K`` and ``num_micro=M`` run the stacked net as a K-stage
        pipeline over its ``pipeline_axis``, as ``make_train_step``
        does).  The step owns its optimizer state.  Refused, as in the
        reference: a trainer that does not
        hold exactly the net's trained parameters, per-parameter
        lr/wd multipliers and an lr scheduler (the step takes the
        learning rate once).  The loss is a mean over the batch, so only
        the optimizer's own ``rescale_grad`` is applied."""
        from ..parallel.train_step import FunctionalOptimizer, TrainStep

        opt = self._optimizer
        mine = {id(p) for p in self._params}
        net_params = list(net.collect_params().values())
        outside = [p.name for p in net_params
                   if p.grad_req != "null" and id(p) not in mine]
        if outside:
            raise ValueError(
                "the fused step trains every trainable parameter of the "
                "net, but this Trainer was built without %s; pass the "
                "whole collect_params() or set grad_req='null' on the "
                "frozen ones" % outside)
        net_ids = {id(p) for p in net_params}
        orphaned = [p.name for p in self._params
                    if p.grad_req != "null" and id(p) not in net_ids]
        if orphaned:
            raise ValueError(
                "this Trainer also owns %s, which are not part of the "
                "given net: the fused step would never update them"
                % orphaned)
        mults = [p.name for p in self._params
                 if p.lr_mult != 1.0 or p.wd_mult != 1.0]
        if mults:
            raise ValueError("per-parameter lr_mult/wd_mult (%s) are not "
                             "applied by the fused step" % mults)
        if opt.lr_scheduler is not None:
            raise ValueError("make_fused_step takes the learning rate at "
                             "build time; an lr_scheduler would be "
                             "frozen")
        if multi_precision is None:
            multi_precision = bool(opt.multi_precision)
        # the step's own copy: Trainer.update sets rescale_grad per batch
        rule = copy.copy(opt)
        rule.lr = float(opt.learning_rate)
        rule.rescale_grad = self._scale
        fopt = FunctionalOptimizer.of(rule, multi_precision)
        return TrainStep(net, loss_fn, fopt, compute_dtype=compute_dtype,
                         loss_scale=loss_scale, nonfinite=nonfinite,
                         device=device, mesh=mesh,
                         pipeline_stages=pipeline_stages,
                         num_micro=num_micro, pipeline_axis=pipeline_axis,
                         pipeline_remat=pipeline_remat)
