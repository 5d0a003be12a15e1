"""BaseModule: the high-level training loop (port of
``incubator_mxnet_tpu/module/base_module.py``,
``python/mxnet/module/base_module.py``): ``fit`` (epochs of
``forward_backward``, ``update``, ``update_metric`` and the callbacks,
then validation), ``score``, ``predict``, ``save_params``/
``load_params``.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from ..base import MXNetError

__all__ = ["BaseModule", "BatchEndParam"]


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):  # noqa: A002
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """``eval_metric`` over ``eval_data`` (inference forwards), as
        ``[(name, value)]``."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("Module must be binded and initialized")
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for cb in _as_list(batch_end_callback or []):
                cb(BatchEndParam(epoch, nbatch, eval_metric))
        for cb in _as_list(score_end_callback or []):
            cb(BatchEndParam(epoch, nbatch, eval_metric))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """The outputs over ``eval_data``, padding cut off; merged over
        the batches into one NDArray per output unless not
        ``merge_batches``."""
        from ..ndarray import array

        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            outputs = self.get_outputs()
            if eval_batch.pad:
                outputs = [o[:o.shape[0] - eval_batch.pad] for o in outputs]
            output_list.append([o.copy() for o in outputs])
        if not output_list or not merge_batches:
            return output_list
        merged = [array(np.concatenate([b[i].asnumpy() for b in output_list]),
                        ctx=output_list[0][i].context)
                  for i in range(len(output_list[0]))]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Bind, initialize (default ``Uniform(0.01)``) and train
        ``num_epoch`` epochs, scoring ``eval_data`` after each."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        from .. import initializer as init_mod

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = metric_mod.create(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                for cb in _as_list(batch_end_callback or []):
                    cb(BatchEndParam(epoch, nbatch, eval_metric,
                                     locals=locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            for cb in _as_list(epoch_end_callback or []):
                cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    # the interface a module implements
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    def save_params(self, fname):
        """The parameters as a ``.params`` file (``arg:``/``aux:``
        keys)."""
        from ..ndarray import save as nd_save

        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd_save(fname, save_dict)

    def load_params(self, fname):
        from ..ndarray import load as nd_load

        arg_params, aux_params = {}, {}
        for k, value in nd_load(fname, self._device).items():
            tp, name = k.split(":", 1)
            if tp == "arg":
                arg_params[name] = value
            elif tp == "aux":
                aux_params[name] = value
        self.set_params(arg_params, aux_params)
