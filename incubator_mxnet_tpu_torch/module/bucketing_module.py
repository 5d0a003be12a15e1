"""BucketingModule: one ``Module`` per bucket for variable-length
sequences (port of ``incubator_mxnet_tpu/module/bucketing_module.py``; the
reference's ``python/mxnet/module/bucketing_module.py:40``).

``sym_gen(bucket_key)`` gives each bucket's symbol, data names and label
names; each bucket binds its own ``Module`` on the module's device
(``context=None``: the card).  The buckets hold one logical parameter
set, as in the reference's scheme: the freshest parameters are copied
into a bucket when the module switches to it, and into the default
bucket after each ``update`` elsewhere; every bucket bound after
``init_optimizer`` shares the default bucket's optimizer and updater.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        if default_bucket_key is None:
            raise ValueError("please specify default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._opt_config = None

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            mod = Module(sym, data_names, label_names, self.logger,
                         self._context,
                         fixed_param_names=self._fixed_param_names)
            self._buckets[bucket_key] = mod
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind, None, grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        default_mod = self._buckets[self._default_bucket_key]
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self.inputs_need_grad)
            if self._opt_config is not None and default_mod._updater is not None:
                mod._optimizer = default_mod._optimizer
                mod._updater = default_mod._updater
                mod.optimizer_initialized = True
        # parameters live logically in one shared set: sync the freshest copy
        # (reference shares executor memory across buckets instead)
        if mod is not self._curr_module and self._curr_module is not None \
                and self._curr_module.params_initialized:
            arg, aux = self._curr_module.get_params()
            mod.set_params(arg, aux, allow_missing=True, allow_extra=True)
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init, allow_extra)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._buckets[self._default_bucket_key].init_optimizer(
            kvstore, optimizer, optimizer_params, force_init)
        self._opt_config = (kvstore, optimizer, optimizer_params)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if data_batch.bucket_key != self._curr_bucket_key:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
        # sync params from previous module
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()
        # propagate updated params to the shared default module if needed
        if self._curr_bucket_key != self._default_bucket_key:
            arg, aux = self._curr_module.get_params()
            self._buckets[self._default_bucket_key].set_params(
                arg, aux, allow_extra=True)

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self._curr_module.set_params(arg_params, aux_params, allow_missing,
                                     force_init, allow_extra)
        self.params_initialized = True

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            if mod.binded:
                mod.install_monitor(mon)

    def switch_to(self, bucket_key):
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
