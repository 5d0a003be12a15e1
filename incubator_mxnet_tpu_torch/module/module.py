"""Module: symbolic training over one :class:`..executor.Executor` (port
of ``incubator_mxnet_tpu/module/module.py``,
``python/mxnet/module/module.py``).

A Module binds its symbol on one device: ``context=None`` is the card
(``context.resolve(None)``), where the reference defaults to ``cpu()``;
tests pass ``context=mx.cpu()``.  A list of more than one context raises:
data parallelism over several cards of one process is ROADMAP A8 item
1b.  ``init_optimizer``
gives ``rescale_grad = 1 / batch`` unless told otherwise, as the
reference does, and updates each parameter through the optimizer's
``Updater``; the kvstore argument is taken and, as in the reference's
single-device Module, not used.
"""
from __future__ import annotations

import logging

from .. import context as _ctx
from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..executor import Executor, _tensor
from ..io import DataDesc
from ..ndarray import zeros
from .base_module import BaseModule, _as_list

__all__ = ["Module"]


def _device_of(context):
    if isinstance(context, (list, tuple)):
        if len(context) > 1:
            raise NotImplementedError(
                "a Module over %d contexts (data parallelism across the "
                "cards of one process) waits for ROADMAP A8 item 1b; for "
                "data parallelism over processes use kv.create("
                "'dist_sync') or a TrainStep over a dp mesh" % len(context))
        context = context[0] if context else None
    return _ctx.resolve(context)


def _descs(shapes):
    return [d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in (shapes or [])]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        self._symbol = symbol
        self._device = _device_of(context)
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._data_shapes = []
        self._label_shapes = []
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._preloaded = None
        self._preload_opt_states = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, o.shape) for n, o in zip(self.output_names,
                                             self._exec.outputs)]

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Infer every shape from the inputs' and bind zero-filled arrays
        on the module's device; data and labels take no gradient (data
        does with ``inputs_need_grad``), nor do the fixed parameters."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        shapes = {d.name: d.shape
                  for d in self._data_shapes + self._label_shapes}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        args, grads, req = {}, {}, {}
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            args[name] = zeros(shape, ctx=self._device)
            is_data = name in self._data_names
            if name in self._label_names or not for_training \
                    or (is_data and not inputs_need_grad) \
                    or name in self._fixed_param_names:
                req[name] = "null"
            else:
                req[name] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(name, "write")
            if req[name] != "null":
                grads[name] = zeros(shape, ctx=self._device)
        aux = {n: zeros(s, ctx=self._device)
               for n, s in zip(self._aux_names, aux_shapes)}
        self._exec = Executor(self._symbol, self._device, args, grads, req,
                              aux)
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill each parameter and auxiliary state from ``arg_params``/
        ``aux_params`` (or a loaded checkpoint's) where named there, else
        by ``initializer`` (default ``Uniform(0.01)``)."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if self._preloaded is not None:
            arg_params = arg_params or self._preloaded[0]
            aux_params = aux_params or self._preloaded[1]
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        attrs = self._symbol.attr_dict()
        for names, given, arrays in (
                (self._param_names, arg_params, self._exec.arg_dict),
                (self._aux_names, aux_params, self._exec.aux_dict)):
            for name in names:
                arr = arrays[name]
                if given is not None and name in given:
                    arr._set_data(_tensor(given[name], self._device)
                                  .to(arr._data.dtype, copy=True))
                else:
                    initializer(init_mod.InitDesc(name, attrs.get(name, {})),
                                arr)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                batch = self._data_shapes[0].shape[0] \
                    if self._data_shapes else 1
                optimizer_params["rescale_grad"] = 1.0 / max(batch, 1)
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        inputs = dict(zip(self._data_names, _as_list(data_batch.data)))
        if data_batch.label is not None:
            inputs.update(zip(self._label_names,
                              _as_list(data_batch.label)))
        self._exec.forward(is_train=is_train, **inputs)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        """One ``Updater`` call for each parameter that takes a
        gradient."""
        for i, name in enumerate(self._param_names):
            if self._exec.grad_req.get(name, "null") != "null":
                self._updater(i, self._exec.grad_dict[name],
                              self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def get_params(self):
        return ({n: self._exec.arg_dict[n].copy() for n in self._param_names},
                {n: self._exec.aux_dict[n].copy() for n in self._aux_names})

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Copy the given arrays into the bound ones."""
        if not allow_missing:
            for name in self._param_names:
                if arg_params is None or name not in arg_params:
                    raise MXNetError("missing parameter %r" % name)
        for given, arrays, kind in ((arg_params, self._exec.arg_dict,
                                     "parameter"),
                                    (aux_params, self._exec.aux_dict,
                                     "aux state")):
            for name, v in (given or {}).items():
                if name in arrays:
                    arrays[name]._set_data(_tensor(v, self._device).to(
                        arrays[name]._data.dtype, copy=True))
                elif not allow_extra:
                    raise MXNetError("unknown %s %r" % (kind, name))
        self.params_initialized = True

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(_as_list(labels), self._exec.outputs)

    def install_monitor(self, mon):
        mon.install(self._exec)

    # ------------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` (and
        ``prefix-%04d.states`` with the optimizer's states)."""
        from ..model import save_checkpoint

        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol whose ``init_params`` takes
        the checkpoint's parameters."""
        from ..model import load_checkpoint

        sym, args, auxs = load_checkpoint(
            prefix, epoch, _device_of(kwargs.get("context")))
        mod = Module(symbol=sym, **kwargs)
        mod._preloaded = (args, auxs)
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_optimizer_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), ctx=self._device)

    def reshape(self, data_shapes, label_shapes=None):
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        self._exec = self._exec.reshape(
            **{d.name: d.shape
               for d in self._data_shapes + self._label_shapes})
