"""Optimizers (port of ``incubator_mxnet_tpu/optimizer/optimizer.py``): the
registry (``register``/``create``), the ``Optimizer`` base with its
learning-rate and weight-decay multipliers (by ``param_dict`` or by
``idx2name`` with ``set_lr_mult``/``set_wd_mult``), ``num_update``,
``clip_gradient``, ``rescale_grad``, ``multi_precision`` (f32 master
weights for float16 weights, as in the reference) and
``lr_scheduler``; the 19 registered optimizers; ``Updater`` with
``get_states``/``set_states``.

Each optimizer computes its update once, in ``_step(weight, grad,
state, lr, wd, t, index)`` on tensors, through the update ops of
``ops/optimizer_ops.py`` where the reference calls one: ``update``
applies it to NDArrays in place (the weight's tensor is written, so a
``Parameter.data()`` keeps its tensor), and the fused train step
(``parallel.FunctionalOptimizer``) applies it to the step's tensors,
with ``t`` then a tensor on the device.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..ndarray import NDArray
from ..ops import optimizer_ops as _oops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "Adamax", "Nadam", "Signum", "SignSGD",
           "FTML", "LAMB", "DCASGD", "LBSGD", "AdamW", "LARS", "SGLD",
           "ccSGD", "Updater", "get_updater", "create", "register"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """The optimizer registered as ``name`` (an instance passes)."""
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _OPT_REGISTRY:
        raise ValueError("Unknown optimizer %r (known: %s)"
                         % (name, sorted(_OPT_REGISTRY)))
    return _OPT_REGISTRY[key](**kwargs)


def _pow(base, t):
    """``base ** t``: a float for a host count, an f32 tensor for the
    fused step's device count."""
    if isinstance(t, torch.Tensor):
        return torch.pow(torch.full((), base, dtype=torch.float32,
                                    device=t.device), t.float())
    return base ** t


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _zeros(w):
    return torch.zeros_like(w)


def _clip(g, clip_gradient):
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _nd(x):
    """A state of tensors as NDArrays (None stays None)."""
    if isinstance(x, tuple):
        return tuple(_nd(i) for i in x)
    return None if x is None else NDArray(x)


def _tensors(x):
    if isinstance(x, tuple):
        return tuple(_tensors(i) for i in x)
    return None if x is None else x._data


def _assign(state, new):
    """Swap each NDArray of ``state`` to the tensor of ``new``."""
    if isinstance(state, tuple):
        for s, n in zip(state, new):
            _assign(s, n)
    elif state is not None:
        state._set_data(new)


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self._index_update_count: Dict[Any, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self._lr_mult: Dict[str, float] = {}
        self._wd_mult: Dict[str, float] = {}

    create_optimizer = staticmethod(create)

    # -------------------------------------------------------------- state
    def _state(self, weight):
        """Fresh state for a weight tensor: a tensor, a tuple or None."""
        return None

    def create_state(self, index, weight):
        return _nd(self._state(weight._data))

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == np.float16:
            w32 = weight.astype("float32")
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        """``(new_weight, new_state)`` for tensors; ``t`` is the 1-based
        update count of this index."""
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        self._update_count(index)
        w, s = self._step(weight._data, grad._data, _tensors(state),
                          self._get_lr(index), self._get_wd(index),
                          self._index_update_count[index], index)
        weight._set_data(w)
        _assign(state, s)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype == np.float16:
            s32, w32 = state
            self.update(index, w32, grad.astype("float32"), s32)
            weight._set_data(w32._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    # ------------------------------------------------------------- lr, wd
    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self._lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self._wd_mult[n] = 0.0
        self._wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _name(self, index):
        return self.idx2name.get(index, index if isinstance(index, str)
                                 else None)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        name = self._name(index)
        if name in self.param_dict:
            lr *= self.param_dict[name].lr_mult
        elif name in self._lr_mult:
            lr *= self._lr_mult[name]
        return lr

    def _get_wd(self, index):
        wd = self.wd
        name = self._name(index)
        if name in self.param_dict:
            wd *= self.param_dict[name].wd_mult
        elif name in self._wd_mult:
            wd *= self._wd_mult[name]
        return wd

    def _op_kwargs(self, lr, wd):
        kw = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)


@register
class SGD(Optimizer):
    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def _state(self, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        kw = self._op_kwargs(lr, wd)
        if state is not None:
            return _oops.sgd_mom_update(weight, grad, state,
                                        momentum=self.momentum, **kw)
        return _oops.sgd_update(weight, grad, **kw), None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == np.float16:
            w32 = weight.astype("float32")
            mom = NDArray(torch.zeros_like(w32._data)) if self.momentum \
                else None
            return (mom, w32)
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision and weight.dtype == np.float16):
            return self.update(index, weight, grad, state)
        mom, w32 = state
        # the reference reads lr before counting this update
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        w32n, m = self._step(w32._data, grad._data.float(), _tensors(mom),
                             lr, wd, self._index_update_count[index], index)
        _assign(mom, m)
        weight._set_data(w32n.to(weight._data.dtype))
        w32._set_data(w32n)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def _state(self, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        kw = self._op_kwargs(lr, wd)
        if state is not None:
            return _oops.nag_mom_update(weight, grad, state,
                                        momentum=self.momentum, **kw)
        return _oops.sgd_update(weight, grad, **kw), None


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        kw = self._op_kwargs(lr, wd)
        kw["lr"] = lr * _sqrt(1.0 - _pow(self.beta2, t)) \
            / (1.0 - _pow(self.beta1, t))
        mean, var = state
        w, m, v = _oops.adam_update(weight, grad, mean, var,
                                    beta1=self.beta1, beta2=self.beta2,
                                    epsilon=self.epsilon, **kw)
        return w, (m, v)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def _state(self, weight):
        return _zeros(weight)

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        return _oops.adagrad_update(weight, grad, state,
                                    epsilon=self.float_stable_eps,
                                    **self._op_kwargs(lr, wd))


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def _state(self, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        kw = self._op_kwargs(lr, wd)
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            n, g, delta = state
            w, n2, g2, d2 = _oops.rmspropalex_update(
                weight, grad, n, g, delta, gamma1=self.gamma1,
                gamma2=self.gamma2, epsilon=self.epsilon, **kw)
            return w, (n2, g2, d2)
        return _oops.rmsprop_update(weight, grad, state, gamma1=self.gamma1,
                                    epsilon=self.epsilon, **kw)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        acc_g, acc_delta = state
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        new_acc_g = self.rho * acc_g + (1 - self.rho) * g * g
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(new_acc_g + self.epsilon)) * g
        new_acc_delta = self.rho * acc_delta \
            + (1 - self.rho) * delta * delta
        return weight - delta - wd * weight, (new_acc_g, new_acc_delta)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        z, n = state
        w, z2, n2 = _oops.ftrl_update(weight, grad, z, n,
                                      lamda1=self.lamda1, beta=self.beta,
                                      **self._op_kwargs(lr, wd))
        return w, (z2, n2)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        lr = lr / (1.0 - _pow(self.beta1, t))
        m, u = state
        g = _clip(grad * self.rescale_grad + wd * weight,
                  self.clip_gradient)
        m = self.beta1 * m + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        return weight - lr * m / (u + 1e-8), (m, u)


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        m, v = state
        g = _clip(grad * self.rescale_grad + wd * weight,
                  self.clip_gradient)
        momentum_t = self.beta1 * (
            1.0 - 0.5 * _pow(0.96, t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * _pow(0.96, (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        g_prime = g / (1.0 - self.m_schedule)
        m = self.beta1 * m + (1.0 - self.beta1) * g
        v = self.beta2 * v + (1.0 - self.beta2) * g * g
        m_prime = m / (1.0 - m_schedule_next)
        v_prime = v / (1.0 - _pow(self.beta2, t))
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        w = weight - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon)
        return w, (m, v)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def _state(self, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        kw = self._op_kwargs(lr, wd)
        if state is not None:
            return _oops.signum_update(weight, grad, state,
                                       momentum=self.momentum,
                                       wd_lh=self.wd_lh, **kw)
        return _oops.signsgd_update(weight, grad, **kw), None


@register
class SignSGD(Signum):
    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        kw = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_grad"] = self.clip_gradient
        d, v, z = state
        w, d2, v2, z2 = _oops.ftml_update(weight, grad, d, v, z, t=t,
                                          beta1=self.beta1,
                                          beta2=self.beta2,
                                          epsilon=self.epsilon, **kw)
        return w, (d2, v2, z2)


@register
class LAMB(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        mean, var = state
        kw1 = {"beta1": self.beta1, "beta2": self.beta2,
               "epsilon": self.epsilon, "t": t,
               "bias_correction": self.bias_correction, "wd": wd,
               "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw1["clip_gradient"] = self.clip_gradient
        g, m, v = _oops.lamb_update_phase1(weight, grad, mean, var, **kw1)
        kw2 = {"lr": lr}
        if self.lower_bound is not None:
            kw2["lower_bound"] = self.lower_bound
        if self.upper_bound is not None:
            kw2["upper_bound"] = self.upper_bound
        return _oops.lamb_update_phase2(weight, g, None, **kw2), (m, v)


@register
class DCASGD(Optimizer):
    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous: Dict[Any, Any] = {}
        self.lamda = lamda

    def _state(self, weight):
        mom = None if self.momentum == 0.0 else _zeros(weight)
        return (mom, weight.clone())

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        mom, prev = state
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        g = g + wd * weight + self.lamda * g * g * (weight - prev)
        if mom is not None:
            mom = self.momentum * mom - lr * g
            upd = mom
        else:
            upd = -lr * g
        return weight + upd, (mom, weight)


@register
class LBSGD(SGD):
    """Large-batch SGD: the reference's update is SGD's; its warm-up
    arguments are taken and not used."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (``_adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def _state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        mean, var = state
        rescale = torch.full((1,), float(self.rescale_grad),
                             dtype=torch.float32, device=weight.device)
        kw = {"lr": lr, "wd": wd, "beta1": self.beta1, "beta2": self.beta2,
              "epsilon": self.epsilon, "eta": self.eta}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        w, m, v = _oops.adamw_update(weight, grad, mean, var, rescale, **kw)
        return w, (m, v)


Test = SGD


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: SGD with momentum whose lr is
    scaled per layer by ``eta * ||w|| / (||g|| + wd * ||w|| + eps)``;
    parameters named ``*bias``/``*gamma``/``*beta`` skip the scaling."""

    def __init__(self, momentum=0.0, eta=0.001, eps=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.eps = eps

    def _state(self, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _skip_scaling(self, index):
        name = self.idx2name.get(index, str(index))
        return name.endswith(("bias", "gamma", "beta"))

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        if not self._skip_scaling(index):
            w_norm = torch.linalg.vector_norm(weight)
            g_norm = torch.linalg.vector_norm(g)
            ratio = self.eta * w_norm / (g_norm + wd * w_norm + self.eps)
            both = (w_norm > 0) & (g_norm > 0)
            lr_t = lr * torch.where(both, ratio.reshape(1),
                                    torch.ones(1, dtype=weight.dtype,
                                               device=weight.device))
        else:
            lr_t = lr
        step = lr_t * (g + wd * weight)
        if state is not None:
            state = self.momentum * state + step
            step = state
        return weight - step, state


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half an SGD step plus
    N(0, lr) noise from the port's ``random`` generator of the weight's
    device."""

    @staticmethod
    def _noise(weight, scale):
        from .. import random

        return torch.randn(weight.shape, dtype=weight.dtype,
                           device=weight.device,
                           generator=random.generator(weight.device)) * scale

    def _step(self, weight, grad, state, lr, wd, t, index=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        noise = self._noise(weight, float(lr) ** 0.5)
        return weight - (lr / 2) * (g + wd * weight) + noise, None


@register
class ccSGD(SGD):  # noqa: N801 - the reference's name
    """Deprecated alias of SGD, kept for configurations that name it."""


class Updater:
    """The state-carrying update closure of an optimizer: ``updater(index,
    grad, weight)`` makes the index's state at first use and updates the
    weight in place."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
                self.states_synced[i] = True
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False):
        """The states as pickled numpy (the reference's format), with the
        optimizer when ``dump_optimizer``."""
        def _np(x):
            if isinstance(x, NDArray):
                return x.asnumpy()
            if isinstance(x, tuple):
                return tuple(_np(i) for i in x)
            return x

        serial = {k: _np(v) for k, v in self.states.items()}
        return pickle.dumps((serial, self.optimizer) if dump_optimizer
                            else serial)

    def set_states(self, states, ctx=None):
        """Load states written by :meth:`get_states` of either package
        onto ``ctx`` (default: the device of an existing state, else the
        card): the device of the weights they will update."""
        from .. import context
        from ..ndarray import array

        data = pickle.loads(states)
        if isinstance(data, tuple):
            states_np, self.optimizer = data
        else:
            states_np = data
        dev = ctx if ctx is not None else next(
            (t.device for t in _leaves(self.states)), None)

        def _nd_of(x):
            if isinstance(x, tuple):
                return tuple(_nd_of(i) for i in x)
            if x is None:
                return None
            return array(np.asarray(x), ctx=dev if dev is not None
                         else context.resolve(None))

        self.states = {k: _nd_of(v) for k, v in states_np.items()}
        self.states_synced = {k: True for k in self.states}


def _leaves(states):
    for v in states.values():
        stack = [v]
        while stack:
            x = stack.pop()
            if isinstance(x, tuple):
                stack.extend(x)
            elif isinstance(x, NDArray):
                yield x._data


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
