"""The training step on one device (port of ``incubator_mxnet_tpu/parallel/
train_step.py``: ``DynamicLossScale``, ``FunctionalOptimizer`` for sgd,
``TrainStep`` and ``make_train_step``).

One call runs forward, backward and the optimizer update:

- the dtype policy of the reference's ``_cast_inputs``: every floating
  parameter (BN gamma and beta too) is cast to the compute dtype for the
  forward, the running stats are not, unsigned-int inputs are promoted;
  gradients land in f32 on the master parameters through the cast;
- the loss closure: ``loss_fn(net(x), y).mean()`` in f32, times the loss
  scale when one is set;
- ``_finish_step``: with a dynamic loss scale (which implies the
  reference's ``nonfinite="skip"``), one finiteness reduction over all
  gradients and a select that leaves params, running stats, optimizer
  state and the step counter as they were on a non-finite step; the
  scale halves on overflow and doubles after ``scale_window`` clean
  steps.  Then unscale and update.

The finiteness flag, the counters and the scale stay tensors on the
device: a step never waits for the host.
"""
from __future__ import annotations

from typing import List

import torch
from torch.func import functional_call

from .. import context
from ..ops import optimizer_ops as _oops

__all__ = ["DynamicLossScale", "FunctionalOptimizer", "TrainStep",
           "make_train_step"]


class DynamicLossScale:
    """Dynamic loss-scaling policy: halve (down to ``min_loss_scale``) on
    an overflowing step, double (up to ``max_loss_scale``) after
    ``scale_window`` consecutive clean steps."""

    def __init__(self, init_scale=2.**16, scale_factor=2., scale_window=2000,
                 max_loss_scale=2.**24, min_loss_scale=1.0):
        if init_scale <= 0 or scale_factor <= 1:
            raise ValueError("init_scale must be > 0 and scale_factor > 1")
        if int(scale_window) < 1:
            raise ValueError("scale_window must be >= 1")
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.max_loss_scale = float(max_loss_scale)
        self.min_loss_scale = float(min_loss_scale)


class FunctionalOptimizer:
    """SGD in MXNet's update form, with momentum and ``multi_precision``
    f32 master weights (the last leaf of each parameter's state).  The
    other optimizers of the reference, gradient clipping and
    ``rescale_grad`` wait for ROADMAP item A5b."""

    def __init__(self, name="sgd", learning_rate=0.01, momentum=0.9, wd=0.0,
                 multi_precision=False):
        if name != "sgd":
            raise NotImplementedError(
                "only sgd is ported; %r waits for ROADMAP item A5b" % (name,))
        self.name = name
        self.lr = learning_rate
        self.momentum = momentum
        self.wd = wd
        self.multi_precision = bool(multi_precision)

    @property
    def has_state(self):
        return self.multi_precision or bool(self.momentum)

    def init(self, param_vals: List[torch.Tensor]):
        """Fresh per-parameter state; accumulators and master weights are
        f32 whatever the parameter dtype."""
        def w32(p):
            return p.detach().to(torch.float32, copy=True)

        if self.multi_precision:
            if self.momentum:
                return [(torch.zeros_like(p, dtype=torch.float32), w32(p))
                        for p in param_vals]
            return [w32(p) for p in param_vals]
        if self.momentum:
            return [torch.zeros_like(p) for p in param_vals]
        return []

    def apply_single(self, p, g, s):
        """``(weight, grad, state)`` -> ``(new_weight, new_state)``."""
        kw = {"lr": self.lr, "wd": self.wd}
        if self.multi_precision:
            if self.momentum:
                mom32, w32 = s
                w, m2, w32n = _oops.mp_sgd_mom_update(
                    p, g, mom32, w32, momentum=self.momentum, **kw)
                return w, (m2, w32n)
            return _oops.mp_sgd_update(p, g, s, **kw)
        g = g.to(p.dtype)
        if self.momentum:
            return _oops.sgd_mom_update(p, g, s, momentum=self.momentum, **kw)
        return _oops.sgd_update(p, g, **kw), None

    def apply(self, param_vals, grads, states):
        new_p, new_s = [], []
        for i, (p, g) in enumerate(zip(param_vals, grads)):
            w, s2 = self.apply_single(p, g, states[i] if self.has_state
                                      else None)
            new_p.append(w)
            if self.has_state:
                new_s.append(s2)
        return new_p, new_s


class TrainStep:
    """Callable train step bound to a net, a loss and an optimizer::

        step = make_train_step(net, loss_fn, optimizer="sgd",
                               learning_rate=0.1)
        loss = step(x, y)   # 0-d f32 tensor on the device
    """

    def __init__(self, net, loss_fn, opt: FunctionalOptimizer,
                 compute_dtype=None, loss_scale=None, device=None):
        self.device = context.resolve(device)
        for name, t in list(net.named_parameters()) + \
                list(net.named_buffers()):
            if t.device != self.device:
                raise ValueError("%s is on %s, the step on %s"
                                 % (name, t.device, self.device))
        self.net = net
        self.loss_fn = loss_fn
        self.opt = opt
        self.compute_dtype = getattr(torch, compute_dtype) \
            if isinstance(compute_dtype, str) else compute_dtype
        if loss_scale == "dynamic":
            loss_scale = DynamicLossScale()
        if loss_scale is not None and \
                not isinstance(loss_scale, DynamicLossScale):
            raise ValueError("loss_scale must be None, 'dynamic' or a "
                             "DynamicLossScale (static scales wait for "
                             "ROADMAP item A5b); got %r" % (loss_scale,))
        self._scale_cfg = loss_scale
        named = list(net.named_parameters())
        self._names = [n for n, _ in named]
        self._gp = [p for _, p in named]
        self._aux = list(net.buffers())
        self._opt_state = opt.init(self._gp)
        init_scale = 1.0 if loss_scale is None else loss_scale.init_scale
        dev = self.device
        self._scale = torch.tensor(init_scale, dtype=torch.float32, device=dev)
        self._unskipped = torch.zeros((), dtype=torch.int32, device=dev)
        self._skipped = torch.zeros((), dtype=torch.int32, device=dev)
        self._step = torch.zeros((), dtype=torch.int32, device=dev)

    def _cast_inputs(self, pv, x):
        cd = self.compute_dtype
        if cd is not None:
            pv_c = [v.to(cd) if v.is_floating_point() else v for v in pv]
            floating = x.is_floating_point() or x.dtype == torch.uint8
            return pv_c, (x.to(cd) if floating else x)
        return pv, (x.float() if x.dtype == torch.uint8 else x)

    def _loss(self, x, y):
        pv_c, x_c = self._cast_inputs(self._gp, x)
        out = functional_call(self.net, dict(zip(self._names, pv_c)), (x_c,))
        loss = self.loss_fn(out, y).mean().float()
        if self._scale_cfg is not None:
            loss = loss * self._scale
        return loss

    def __call__(self, x, y):
        x = x.to(self.device, non_blocking=True)
        y = y.to(self.device, non_blocking=True)
        guard = self._scale_cfg is not None
        self.net.train()
        old_aux = [b.clone() for b in self._aux] if guard else None
        with torch.enable_grad():
            loss = self._loss(x, y)
            grads = torch.autograd.grad(loss, self._gp)
        with torch.no_grad():
            return self._finish_step(loss.detach(), list(grads), old_aux)

    def _finish_step(self, loss, grads, old_aux):
        guard = old_aux is not None
        ok = _oops.tree_all_finite(grads) if guard else None
        if guard:
            inv = 1.0 / self._scale
            grads = [(g.float() * inv).to(g.dtype) for g in grads]
            loss = loss * inv
        new_p, new_s = self.opt.apply([p.detach() for p in self._gp], grads,
                                      self._opt_state)
        if guard:
            new_p = [torch.where(ok, n, p) for n, p in zip(new_p, self._gp)]
            new_s = _tree_where(ok, new_s, self._opt_state)
            for b, old in zip(self._aux, old_aux):
                b.copy_(torch.where(ok, b, old))
            self._step += ok.to(torch.int32)
            self._skipped += (~ok).to(torch.int32)
            cfg = self._scale_cfg
            unsk = torch.where(ok, self._unskipped + 1,
                               torch.zeros_like(self._unskipped))
            grow = unsk >= cfg.scale_window
            up = torch.where(grow, torch.clamp_max(
                self._scale * cfg.scale_factor, cfg.max_loss_scale),
                self._scale)
            down = torch.clamp_min(self._scale / cfg.scale_factor,
                                   cfg.min_loss_scale)
            self._scale.copy_(torch.where(ok, up, down))
            self._unskipped.copy_(torch.where(
                grow, torch.zeros_like(unsk), unsk))
        else:
            self._step += 1
        for p, n in zip(self._gp, new_p):
            p.copy_(n)
        self._opt_state = new_s
        return loss

    @property
    def loss_scale(self):
        """The current loss scale (reads the device state)."""
        return float(self._scale)

    @property
    def skipped_steps(self):
        return int(self._skipped)

    @property
    def step_count(self):
        """Applied updates (skipped steps excluded)."""
        return int(self._step)


def _tree_where(ok, new, old):
    if isinstance(new, (list, tuple)):
        return type(new)(_tree_where(ok, n, o) for n, o in zip(new, old))
    return torch.where(ok, new, old)


def make_train_step(net, loss_fn, optimizer="sgd", compute_dtype=None,
                    loss_scale=None, device=None, **opt_kwargs) -> TrainStep:
    """Build the train step (forward + backward + update per call).

    ``optimizer="sgd"`` with ``learning_rate``, ``momentum``, ``wd`` and
    ``multi_precision``.  ``loss_scale`` is None, ``"dynamic"`` or a
    :class:`DynamicLossScale`; a dynamic scale skips non-finite steps
    (the reference's ``nonfinite="skip"``).  ``device`` defaults to the
    CUDA card and must hold the net's parameters."""
    opt = FunctionalOptimizer(optimizer, **opt_kwargs)
    return TrainStep(net, loss_fn, opt, compute_dtype=compute_dtype,
                     loss_scale=loss_scale, device=device)
