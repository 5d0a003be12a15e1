"""The training step on one device (port of ``incubator_mxnet_tpu/parallel/
train_step.py``: ``DynamicLossScale``, ``FunctionalOptimizer`` over every
registered optimizer, ``TrainStep`` and ``make_train_step``).

One call runs forward, backward and the optimizer update:

- the reference's split of the net's tensors: parameters with a
  gradient are updated; running stats and parameters without gradient
  (``requires_grad=False``, the reference's ``grad_req="null"``) form
  the aux set, in ``collect_params()`` order;
- the dtype policy of the reference's ``_cast_inputs``: every floating
  trained parameter (BN gamma and beta too) is cast to the compute
  dtype for the forward, the aux set is not, unsigned-int inputs are
  promoted;
  gradients land in f32 on the master parameters through the cast;
- the loss closure: ``loss_fn(net(x), y).mean()`` in f32, times the loss
  scale when one is set;
- ``_finish_step``: with ``nonfinite="skip"`` or ``"raise"`` (implied
  by a dynamic loss scale), one finiteness reduction over all gradients
  and a select that leaves params, running stats, optimizer state and
  the step counter as they were on a non-finite step; a dynamic scale
  halves on overflow and doubles after ``scale_window`` clean steps.
  Then unscale (static or dynamic scale) and update; ``"raise"`` raises
  ``FloatingPointError`` after a skipped step.

The finiteness flag, the counters and the scale stay tensors on the
device: a step never waits for the host.

Over a data-parallel mesh (``mesh=make_mesh({"dp": N})``, one process
per device) each rank is given its slice of the global batch
(:meth:`~.mesh.Mesh.local_slice`) and the step computes what the
reference's one program computes over the whole batch: the loss is the
global mean, the gradients are averaged over the dp group before the
non-finite guard (so every rank takes the same skip decision and the
same loss-scale move), stock batch norm takes the global batch's
statistics and ghost batch norm's running stats merge over the ranks
(:func:`~.collectives.dp_scope`).  The gradients, the loss and the
running stats travel in one ``all_reduce`` per dtype.  ``zero=1``
(ZeRO-1) reduce-scatters the gradients on their leading dim instead,
padded to a multiple of N as the reference pads a ragged dim; each rank
updates its 1/N of the weights against its 1/N of the optimizer state
(and of the f32 master weights), and an all-gather puts the weights
back together.  Replicas stay bit-identical across the ranks.

Model parallelism on a mesh of several axes (the reference's GSPMD
layouts, made explicit): ``param_shardings`` keeps a tensor- or
expert-parallel parameter as this rank's part (and its optimizer
state), all-gathered in the forward by the differentiable
``collectives.allgather`` (whose backward keeps this rank's part of the
gradient), or handed to a block that runs its part (``MoEFFN``'s local
experts).  ``pipeline_stages`` runs the net as a pipeline over the
``pp`` axis: every rank keeps every stage's parameters, computes its own
stage's gradients (zeros for the others'), and one ``all_reduce`` over
``pp`` makes them whole once a step, before the dp reduction.  A
:class:`~..tracing.TraceContext` around the forward collects the aux
losses (MoE load balancing), added in f32 before the loss scale.
Replicated parameters stay bit-identical across the ranks.

``sync="async"`` (or ``"auto"``, degraded by the supervisor's straggler
verdicts) exchanges the gradients through a bounded-staleness parameter
service (:mod:`.param_service`) instead: each call pushes this process's
gradients, compressed with error feedback when ``compression`` is set,
and pulls the service's parameters, which its own copy of the optimizer
updated; the service, the clock and the residuals ride the checkpoint.

The step takes tensors or the port's NDArrays (an iterator's batch:
``step(b.data[0], b.label[0])``).  ``save_checkpoint`` /
``restore_checkpoint`` / ``attach_checkpoint`` write and read the whole
training state through :mod:`.checkpoint`, with the data iterator's
position beside it, in the JAX package's state tree and format: the
reference's ``TrainStep`` and this one restore each other's checkpoints.
Over a mesh that spans processes every rank calls them together on one
shared directory: each rank writes its own rows of every ZeRO-1
optimizer-state leaf (the padded global leaf's rows ``[rank * rows,
(rank + 1) * rows)``), rank 0 the replicated leaves, and rank 0 commits
once every rank's done-marker is in, with each rank's iterator state
beside the others'.  A restore reads back only this rank's rows, the
ranks agree on the step it loads (a corrupt file only one rank reads
sends every rank back to the same older step), and it restores across a changed dp width, process count or ``zero`` mode: the
ZeRO leaves are cut to their logical rows and padded again, the
iterator states re-split (``distributed.resplit_iter_state``).
"""
from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch
from torch.func import functional_call
from torch.nn.parameter import is_lazy

import contextlib

from .. import context
from .. import convert as _convert
from .. import tracing
from ..ndarray import NDArray
from ..ops import optimizer_ops as _oops
from . import checkpoint as _ckpt
from . import collectives
from .pipeline import spmd_pipeline, stage_congruence_mismatch

__all__ = ["DynamicLossScale", "FunctionalOptimizer", "TrainStep",
           "make_train_step"]

#: the mesh axes of model parallelism (tensor, sequence, pipeline,
#: expert); a mesh of these alone replicates the batch
_MODEL_AXES = ("tp", "sp", "pp", "ep")


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
    """An optimizer of ``optimizer.create`` as a function of the step's
    tensors: ``apply(params, grads, states, step_count)`` returns the new
    parameters and states and writes nothing.

    Every registered optimizer runs its own ``_step`` (the update ops of
    ``ops/optimizer_ops.py``); sgd keeps MXNet's update form, adam its
    bias correction in f32 from the 1-based device step count.  With
    ``multi_precision`` the update runs on f32 master weights and the
    state is ``(state, w32)``, except for the reference's fused layouts,
    which checkpoints keep: sgd without momentum holds ``w32`` alone and
    adam ``(mean, var, w32)``.  ``rescale_grad`` multiplies and
    ``clip_gradient`` (>= 0) clips the gradients inside the update, as
    the reference's ops do."""

    def __init__(self, name="sgd", learning_rate=0.01, momentum=None, wd=0.0,
                 multi_precision=False, clip_gradient=-1.0, rescale_grad=1.0,
                 **opt_kwargs):
        from .. import optimizer as _optimizer

        if name.lower() == "sgd" and momentum is None:
            momentum = 0.9
        if momentum is not None:
            opt_kwargs["momentum"] = momentum
        clip = None if clip_gradient is None or clip_gradient < 0 \
            else float(clip_gradient)
        # the update rule (raises for a name no optimizer registered)
        self._bind(_optimizer.create(
            name, learning_rate=learning_rate, wd=wd,
            rescale_grad=float(rescale_grad), clip_gradient=clip,
            **opt_kwargs), multi_precision)

    @classmethod
    def of(cls, opt, multi_precision=False):
        """The update rule of the optimizer instance ``opt``, with its
        learning rate and weight decay as they are now; ``rescale_grad``
        and ``clip_gradient`` are read from ``opt`` at each update."""
        self = cls.__new__(cls)
        self._bind(opt, multi_precision)
        return self

    def _bind(self, opt, multi_precision):
        self._opt = opt
        self.name = type(opt).__name__.lower()
        self.lr = opt.lr
        self.wd = opt.wd
        self.multi_precision = bool(multi_precision)

    @property
    def has_state(self):
        return self.multi_precision or self.name != "sgd" \
            or bool(self._opt.momentum)

    def _pack(self, inner, w32):
        if self.name == "sgd" and inner is None:
            return w32
        if self.name == "adam":
            return (*inner, w32)
        return (inner, w32)

    def _unpack(self, s):
        if self.name == "sgd" and not isinstance(s, tuple):
            return None, s
        if self.name == "adam":
            return s[:2], s[2]
        return s

    def init(self, param_vals: List[torch.Tensor]):
        """Fresh per-parameter state; accumulators and master weights are
        f32 whatever the parameter dtype."""
        if not self.has_state:
            return []
        if self.multi_precision:
            out = []
            for p in param_vals:
                w32 = p.detach().to(torch.float32, copy=True)
                out.append(self._pack(self._opt._state(w32), w32))
            return out
        return [self._opt._state(p.detach()) for p in param_vals]

    def apply_single(self, p, g, s, step_count=None, index=None):
        """``(weight, grad, state)`` -> ``(new_weight, new_state)``;
        ``step_count`` is the 1-based count of applied steps (a tensor),
        ``index`` the parameter's position (the index ``Trainer.step``
        gives the optimizer)."""
        if self.multi_precision:
            inner, w32 = self._unpack(s)
            w32n, inner2 = self._opt._step(w32, g.float(), inner, self.lr,
                                           self.wd, step_count, index)
            return w32n.to(p.dtype), self._pack(inner2, w32n)
        return self._opt._step(p, g.to(p.dtype), s, self.lr, self.wd,
                               step_count, index)

    def apply(self, param_vals, grads, states, step_count=None):
        new_p, new_s = [], []
        for i, (p, g) in enumerate(zip(param_vals, grads)):
            w, s2 = self.apply_single(p, g, states[i] if self.has_state
                                      else None, step_count, i)
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
                 compute_dtype=None, loss_scale=None, nonfinite=None,
                 device=None, mesh=None, batch_axis="dp", zero=0,
                 param_shardings=None, pipeline_stages=None, num_micro=1,
                 pipeline_axis="pp", pipeline_remat=False,
                 skip_streak_budget=None, sync="allreduce",
                 staleness_bound=None, compression=None):
        self.device = context.resolve(device)
        for name, t in list(net.named_parameters()) + \
                list(net.named_buffers()):
            if t.device != self.device:
                raise ValueError("%s is on %s, the step on %s"
                                 % (name, t.device, self.device))
        _check_sync_args(sync, staleness_bound, mesh, pipeline_stages,
                         loss_scale)
        self._init_mesh(mesh, batch_axis, zero, opt)
        self._init_pipeline_args(pipeline_stages, num_micro, pipeline_axis,
                                 pipeline_remat)
        self.net = net
        self.loss_fn = loss_fn
        self.opt = opt
        self.compute_dtype = getattr(torch, compute_dtype) \
            if isinstance(compute_dtype, str) else compute_dtype
        if loss_scale == "dynamic":
            loss_scale = DynamicLossScale()
        if isinstance(loss_scale, (int, float)) and \
                not isinstance(loss_scale, bool):
            if loss_scale <= 0:
                raise ValueError("a static loss_scale must be positive, "
                                 "got %r" % (loss_scale,))
            loss_scale = float(loss_scale)
        elif loss_scale is not None and \
                not isinstance(loss_scale, DynamicLossScale):
            raise ValueError("loss_scale must be None, a positive number, "
                             "'dynamic' or a DynamicLossScale; got %r"
                             % (loss_scale,))
        self._scale_cfg = loss_scale
        dynamic = isinstance(loss_scale, DynamicLossScale)
        if nonfinite is None:
            nonfinite = "skip" if dynamic else "off"
        if nonfinite not in ("skip", "raise", "off"):
            raise ValueError("nonfinite must be 'skip', 'raise' or 'off', "
                             "got %r" % (nonfinite,))
        if dynamic and nonfinite == "off":
            raise ValueError("a dynamic loss scale skips overflowed steps: "
                             "use nonfinite='skip' or 'raise', not 'off'")
        self.nonfinite = nonfinite
        # a declared bound on consecutive skipped steps: the supervised
        # loop (supervisor.run_supervised) enforces it as its detector's
        if skip_streak_budget is not None and int(skip_streak_budget) < 1:
            raise ValueError("skip_streak_budget must be >= 1 or None, "
                             "got %r" % (skip_streak_budget,))
        self.skip_streak_budget = None if skip_streak_budget is None \
            else int(skip_streak_budget)
        tensors = _convert.ordered_tensors(net)
        lazy = [n for n, t in tensors if is_lazy(t)]
        if lazy:
            raise ValueError("%s and %d more have deferred shapes: resolve "
                             "them first (gluon.shape_init)"
                             % (lazy[0], len(lazy) - 1))
        # the reference's split: a parameter without gradient
        # (grad_req="null") sits with the running stats in the aux set,
        # in collect_params() order; it gets no update and no state
        trained = [(n, t) for n, t in tensors
                   if isinstance(t, torch.nn.Parameter) and t.requires_grad]
        self._names = [n for n, _ in trained]
        self._gp = [p for _, p in trained]
        self._aux = [t for _, t in tensors
                     if not (isinstance(t, torch.nn.Parameter)
                             and t.requires_grad)]
        self._init_shardings(param_shardings or {})
        if self.pipeline_stages is not None:
            self._collect_pipeline()
        # ZeRO-1: the padded leading dim of each >= 1-d parameter (None:
        # a 0-d parameter, updated whole, or one sharded by
        # param_shardings, whose state already shards like it); the
        # state is born as this rank's shard of the padded parameter
        self._zero_pad0 = [-(-p.shape[0] // self._n) * self._n
                           if p.dim() >= 1 and i not in self._shards
                           else None
                           for i, p in enumerate(self._gp)] \
            if self.zero else None
        self._opt_state = opt.init(self._update_view(
            [p.detach() for p in self._gp]))
        init_scale = 1.0 if loss_scale is None else loss_scale \
            if isinstance(loss_scale, float) else loss_scale.init_scale
        dev = self.device
        self._scale = torch.tensor(init_scale, dtype=torch.float32, device=dev)
        self._unskipped = torch.zeros((), dtype=torch.int32, device=dev)
        self._skipped = torch.zeros((), dtype=torch.int32, device=dev)
        self._step = torch.zeros((), dtype=torch.int32, device=dev)
        # the reference's device PRNG key (uint32[2]); this step draws no
        # random numbers, so the key only travels from restore to save
        self._rng_key = np.zeros(2, np.uint32)
        self._step_count = 0  # host mirror: calls, skipped steps included
        self._ckpt_manager = None
        self._ckpt_every = None
        self._ckpt_prev_count = 0
        self._ckpt_seen_request = 0
        self._ckpt_data_iter = None
        self._checked_batch = None
        self._init_sync(sync, staleness_bound, compression)

    def _init_sync(self, sync, staleness_bound, compression):
        """The sync→async ladder (:mod:`.param_service`): ``sync`` is
        ``"allreduce"`` (the step as it is), ``"async"`` (bounded-staleness
        push/pull through a :class:`~.param_service.ParamService`) or
        ``"auto"`` (allreduce until the supervisor's straggler verdicts
        degrade it, :class:`~.param_service.SyncPolicy`).  An async-capable
        step attaches its service now, so its checkpoint's tree is the
        same before and after a switch."""
        from ..kvstore.gradient_compression import make_compressor
        from .param_service import SyncPolicy

        self.sync = sync
        self.staleness_bound = 4 if staleness_bound is None \
            else int(staleness_bound)
        self._compression = make_compressor(compression)
        self.sync_policy = SyncPolicy(mode=sync)
        self._applied_sync = "async" if sync == "async" else "allreduce"
        self._svc_client = None
        #: bounded wait of an async pull (StalenessTimeout past it)
        self.pull_timeout = 300.0
        if sync != "allreduce":
            self.attach_param_service()

    def _init_mesh(self, mesh, batch_axis, zero, opt):
        """The reference's checks of ``mesh``/``zero``; sets the dp axis
        size ``_n``, this rank's index ``_rank`` and ``_dp`` (whether the
        step talks to other processes)."""
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.zero = int(zero or 0)
        if self.zero not in (0, 1):
            raise ValueError("zero must be 0 (off) or 1 (ZeRO-1 "
                             "weight-update sharding), got %r" % (zero,))
        if self.zero:
            if mesh is None or batch_axis not in mesh.axis_names:
                raise ValueError(
                    "zero=1 shards the weight update over the %r mesh "
                    "axis — pass a mesh that has it" % batch_axis)
            if opt.name not in ("sgd", "adam"):
                raise ValueError(
                    "zero=1 needs an elementwise update (sgd/adam); "
                    "%r's trust ratio is a global norm over the whole "
                    "weight and cannot run on a 1/N shard" % opt.name)
        self._n, self._rank, self._dp = 1, 0, False
        if mesh is None:
            return
        if mesh.local_device != self.device:
            raise ValueError("this process's device on the mesh is %s, the "
                             "step's %s" % (mesh.local_device, self.device))
        if batch_axis not in mesh.axis_names:
            if not set(mesh.axis_names) <= set(_MODEL_AXES):
                raise ValueError("the mesh has axes %s; the batch axis %r is "
                                 "not one of them" % (mesh.axis_names,
                                                      batch_axis))
            # model axes alone: every rank is given the whole batch
            return
        self._n = mesh.shape[batch_axis]
        self._rank = mesh.axis_index(batch_axis)
        self._dp = mesh.group(batch_axis) is not None

    def _init_pipeline_args(self, stages, num_micro, axis, remat):
        """The reference's checks of the pipeline arguments."""
        self.pipeline_stages = None if stages is None else int(stages)
        self.num_micro = int(num_micro)
        self.pipeline_axis = axis
        self.pipeline_remat = bool(remat)
        if stages is None:
            return
        mesh = self.mesh
        if mesh is None:
            raise ValueError("pipeline_stages requires a mesh with a %r "
                             "axis" % axis)
        if axis not in mesh.axis_names:
            raise ValueError("mesh %s has no %r axis for pipelining"
                             % (mesh, axis))
        if mesh.shape[axis] != self.pipeline_stages:
            raise ValueError("pipeline_stages=%d but mesh axis %r has size "
                             "%d" % (self.pipeline_stages, axis,
                                     mesh.shape[axis]))
        if self.num_micro < 1:
            raise ValueError("num_micro must be >= 1")

    def _init_shardings(self, param_shardings):
        """``param_shardings`` (``{name: P(...)}``, names as
        ``collect_params()`` or ``named_parameters()`` give them): each
        rank keeps only its part of such a parameter along the one
        sharded dim, and with it only that part's optimizer state.  Sets
        ``_shards`` (``{index: (axis, dim)}``) and ``_local_shards``
        (``{id(block): axis}`` of the blocks that take their shards
        whole, ``takes_shards``)."""
        self._shards, self._local_shards, self._gathered = {}, {}, set()
        if not param_shardings:
            return
        pos = {id(p): i for i, p in enumerate(self._gp)}
        by_name = dict(zip(self._names, range(len(self._gp))))
        if hasattr(self.net, "collect_params"):
            for name, prm in self.net.collect_params().items():
                t = prm._tensor
                if t is not None and id(t) in pos:
                    by_name.setdefault(name, pos[id(t)])
        owners = {}
        for mod in self.net.modules():
            for t in mod._parameters.values():
                if t is not None and id(t) in pos:
                    owners.setdefault(pos[id(t)], mod)
        mesh = self.mesh
        for name, spec in param_shardings.items():
            if name not in by_name:
                raise ValueError("param_shardings names %r, which is not a "
                                 "trained parameter of the net" % (name,))
            i = by_name[name]
            p = self._gp[i]
            spec = tuple(spec) if spec is not None else ()
            if len(spec) > p.dim():
                raise ValueError("param_shardings[%r] = %s has %d entries "
                                 "for a %d-dimensional parameter"
                                 % (name, spec, len(spec), p.dim()))
            dims = [(d, a) for d, a in enumerate(spec) if a is not None]
            if not dims:
                continue
            if len(dims) > 1 or not isinstance(dims[0][1], str):
                raise NotImplementedError(
                    "param_shardings[%r] = %s: the port shards a parameter "
                    "on one dim over one mesh axis" % (name, spec))
            dim, axis = dims[0]
            if mesh is None or axis not in mesh.axis_names:
                raise ValueError("param_shardings[%r] shards over %r, which "
                                 "is not an axis of the mesh %s"
                                 % (name, axis, mesh))
            if axis in (self.batch_axis, self.pipeline_axis):
                raise NotImplementedError(
                    "param_shardings[%r] shards over the %r axis; the port "
                    "shards parameters over model axes (tp, ep) only"
                    % (name, axis))
            n = mesh.shape[axis]
            if p.shape[dim] % n:
                raise ValueError(
                    "param_shardings[%r]: dim %d of size %d does not divide "
                    "over mesh axis %r of size %d"
                    % (name, dim, p.shape[dim], axis, n))
            self._shards[i] = (axis, dim)
            owner = owners.get(i)
            if getattr(owner, "takes_shards", False):
                self._local_shards[id(owner)] = axis
            else:
                self._gathered.add(i)
        with torch.no_grad():
            for i, (axis, dim) in self._shards.items():
                p = self._gp[i]
                per = p.shape[dim] // mesh.shape[axis]
                r = mesh.axis_index(axis)
                p.data = p.data.narrow(dim, r * per, per).clone()

    def _whole(self, vals):
        """The forward's values of the trained parameters: a sharded
        one all-gathered over its axis (the backward keeps this rank's
        part of the gradient), unless its block takes shards."""
        if not self._shards:
            return vals
        vals = list(vals)
        for i in sorted(self._gathered):
            axis, dim = self._shards[i]
            vals[i] = collectives.allgather(vals[i], axis, self.mesh,
                                            axis=dim)
        return vals

    def _collect_pipeline(self):
        """Split the net's children into ``pipeline_stages`` contiguous,
        congruent stages; ``_stage_idx[s]`` are stage s's positions in the
        trained parameters, and this rank runs its own stage's blocks."""
        k = self.pipeline_stages
        try:
            children = list(self.net)
        except TypeError:
            raise ValueError(
                "pipeline_stages needs an iterable stacked net "
                "(e.g. HybridSequential); %r is not iterable"
                % type(self.net).__name__)
        if not children or len(children) % k != 0:
            raise ValueError(
                "cannot split %d child blocks into %d pipeline stages"
                % (len(children), k))
        per = len(children) // k
        groups = [children[s * per:(s + 1) * per] for s in range(k)]
        gp_pos = {id(p): i for i, p in enumerate(self._gp)}
        stage_idx = []
        for s, blocks in enumerate(groups):
            tensors = [t for b in blocks
                       for _, t in _convert.ordered_tensors(b)]
            if any(id(t) not in gp_pos for t in tensors):
                raise NotImplementedError(
                    "pipeline stage %d carries auxiliary state (BatchNorm "
                    "running stats etc.); aux writes cannot escape the "
                    "pipelined scan — use LayerNorm/GroupNorm inside "
                    "pipeline stages" % s)
            stage_idx.append([gp_pos[id(t)] for t in tensors])
        covered = {i for idx in stage_idx for i in idx}
        if covered != set(range(len(self._gp))):
            raise ValueError(
                "net has trainable parameters outside its child blocks; "
                "the SPMD pipeline owns the full parameter set")
        sig0 = [(tuple(self._gp[i].shape), self._gp[i].dtype)
                for i in stage_idx[0]]
        for s, idx in enumerate(stage_idx[1:], 1):
            reason = stage_congruence_mismatch(
                sig0, [(tuple(self._gp[i].shape), self._gp[i].dtype)
                       for i in idx], s)
            if reason:
                raise ValueError(
                    "pipeline stages must be structurally congruent "
                    "(%s) — uniform-stage SPMD pipelining runs ONE "
                    "stage program with per-rank values" % reason)
        self._stage_idx = stage_idx
        me = self.mesh.axis_index(self.pipeline_axis)
        self._stage = torch.nn.Sequential(*groups[me])
        self._stage_names = [n for n, _ in _convert.ordered_tensors(
            self._stage)]

    def _update_view(self, vals):
        """``vals`` (one per trained parameter) as the update sees them:
        whole, or under ZeRO-1 this rank's rows of the padded leading
        dim."""
        if not self.zero:
            return vals
        out = []
        for v, pad0 in zip(vals, self._zero_pad0):
            if pad0 is not None:
                rows = pad0 // self._n
                v = _zero_padded(v, pad0)[self._rank * rows:
                                          (self._rank + 1) * rows]
            out.append(v)
        return out

    def _check_batch(self, x):
        """Every rank must hold an equal slice of the global batch: the
        mean of the local means is the global mean only then.  Checked
        once per local batch shape."""
        shape = tuple(x.shape)
        if shape == self._checked_batch:
            return
        sizes = collectives.allgather(
            torch.tensor([shape[0]], dtype=torch.int64, device=x.device),
            self.batch_axis, self.mesh)
        if len(set(sizes.tolist())) != 1:
            raise ValueError(
                "the ranks' batch slices differ (%s): give every rank an "
                "equal slice of the global batch (Mesh.local_slice)"
                % sizes.tolist())
        self._checked_batch = shape

    def _cast_inputs(self, pv, x):
        cd = self.compute_dtype
        if cd is not None:
            pv_c = [v.to(cd) if v.is_floating_point() else v for v in pv]
            floating = x.is_floating_point() or x.dtype == torch.uint8
            return pv_c, (x.to(cd) if floating else x)
        return pv, (x.float() if x.dtype == torch.uint8 else x)

    def _trace(self):
        return tracing.TraceContext(training=True, mesh=self.mesh,
                                    local_shards=self._local_shards)

    def _loss(self, x, y):
        """The step's objective: the mean task loss in f32 plus the aux
        losses registered during the forward, times the loss scale."""
        pv_c, x_c = self._cast_inputs(self._gp, x)
        pv_c = self._whole(pv_c)
        tc = tracing.push_trace(self._trace())
        try:
            if self.pipeline_stages is not None:
                out = self._pipeline_forward(pv_c, x_c)
            else:
                out = functional_call(self.net,
                                      dict(zip(self._names, pv_c)), (x_c,))
            loss = self.loss_fn(out, y).mean().float()
        finally:
            tracing.pop_trace()
        for al in tc.aux_losses:
            loss = loss + al.float()
        if self._scale_cfg is not None:
            loss = loss * self._scale
        return loss

    def _pipeline_forward(self, pv_c, x_c):
        """The net's output through the SPMD pipeline: the batch cut into
        ``num_micro`` microbatches, this rank running its own stage."""
        num_micro = self.num_micro
        if x_c.shape[0] % num_micro:
            raise ValueError("batch %d not divisible into num_micro=%d"
                             % (x_c.shape[0], num_micro))
        micro = x_c.reshape((num_micro, x_c.shape[0] // num_micro)
                            + tuple(x_c.shape[1:]))
        me = self.mesh.axis_index(self.pipeline_axis)
        stage, names = self._stage, self._stage_names

        def stage_fn(ps, h):
            tc = tracing.push_trace(self._trace())
            try:
                out = functional_call(stage, dict(zip(names, ps)), (h,))
            finally:
                tracing.pop_trace()
            if tc.aux_losses:
                raise NotImplementedError(
                    "aux losses inside pipeline stages cannot escape the "
                    "pipelined scan; place MoE blocks outside the "
                    "pipelined net or train without pipeline_stages")
            return out

        outs = spmd_pipeline(stage_fn, [pv_c[i] for i in self._stage_idx[me]],
                             micro, self.pipeline_axis,
                             remat=self.pipeline_remat, mesh=self.mesh)
        return outs.reshape((-1,) + tuple(outs.shape[2:]))

    def __call__(self, x, y):
        x, y = (v._data if isinstance(v, NDArray) else v for v in (x, y))
        x = x.to(self.device, non_blocking=True)
        y = y.to(self.device, non_blocking=True)
        if self._applied_sync == "async":
            return self._async_call(x, y)
        guard = self.nonfinite != "off"
        self.net.train()
        if self._dp:
            self._check_batch(x)
        old_aux = [b.clone() for b in self._aux] if guard else None
        scope = collectives.dp_scope(self.mesh, self.batch_axis) \
            if self._dp else contextlib.nullcontext()
        with torch.enable_grad(), scope as dp:
            loss = self._loss(x, y)
            grads = torch.autograd.grad(loss, self._gp, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._gp, grads)]
            if self.pipeline_stages is not None:
                # each rank holds its own stage's gradients (zeros for
                # the others'): one sum over pp makes them whole, once a
                # step, before the dp reduction
                grads = collectives.allreduce_coalesced(
                    grads, self.pipeline_axis, self.mesh)
            loss, grads, bad = self._reduce(loss.detach(), grads, dp)
            loss, ok = self._finish_step(loss, grads, old_aux, bad)
        self._step_count += 1
        self._maybe_checkpoint()
        if self.nonfinite == "raise" and not bool(ok):
            raise FloatingPointError(
                "non-finite gradients after %d applied updates (call %d of "
                "this step); params and optimizer state were left "
                "unchanged (nonfinite='raise')"
                % (int(self._step), self._step_count))
        return loss

    def _reduce(self, loss, grads, dp):
        """Average the loss and the gradients over the dp group (no-op off
        a mesh).  Returns ``(loss, grads, bad)``: the gradients in the
        update's layout (:meth:`_update_view`) and, under ZeRO-1, the
        count of ranks whose gradient shard is not finite (None
        otherwise: every rank then holds the whole averaged gradient).
        The running stats that ghost BN deferred ride the same
        ``all_reduce``."""
        if dp is None:
            return loss, grads, None
        n, ax, mesh = self._n, self.batch_axis, self.mesh
        extra = dp.deferred_tensors()
        if not self.zero:
            summed = collectives.allreduce_coalesced(
                grads + [loss.reshape(1)] + extra, ax, mesh)
            k = len(grads)
            dp.commit(summed[k + 1:])
            return summed[k][0] / n, [g / n for g in summed[:k]], None
        pads = self._zero_pad0
        cov = [i for i, pad0 in enumerate(pads) if pad0 is not None]
        rest = [i for i, pad0 in enumerate(pads) if pad0 is None]
        shards = collectives.reduce_scatter_coalesced(
            [_zero_padded(grads[i], pads[i]) for i in cov], ax, mesh)
        bad = (~_oops.tree_all_finite(shards)).float().reshape(1)
        summed = collectives.allreduce_coalesced(
            [grads[i] for i in rest] + [loss.reshape(1), bad] + extra, ax,
            mesh)
        k = len(rest)
        dp.commit(summed[k + 2:])
        out = list(grads)
        for i, g in zip(cov, shards):
            out[i] = g / n
        for i, g in zip(rest, summed[:k]):
            out[i] = g / n
        return summed[k][0] / n, out, summed[k + 1][0]

    def _finish_step(self, loss, grads, old_aux, bad=None):
        guard = old_aux is not None
        ok = None
        if guard:
            ok = _oops.tree_all_finite(grads)
            if bad is not None:
                ok = ok & (bad == 0)
        if self._scale_cfg is not None:
            inv = 1.0 / self._scale
            grads = [(g.float() * inv).to(g.dtype) for g in grads]
            loss = loss * inv
        # the 1-based count of applied steps, for the bias corrections
        count = None if self.opt.name == "sgd" else self._step + 1
        cur = self._update_view([p.detach() for p in self._gp])
        new_p, new_s = self.opt.apply(cur, grads, self._opt_state, count)
        if guard:
            new_p = [torch.where(ok, n, p) for n, p in zip(new_p, cur)]
            new_s = _tree_where(ok, new_s, self._opt_state)
            for b, old in zip(self._aux, old_aux):
                b.copy_(torch.where(ok, b, old))
            self._step += ok.to(torch.int32)
            self._skipped += (~ok).to(torch.int32)
        if isinstance(self._scale_cfg, DynamicLossScale):
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
        if not guard:
            self._step += 1
        if self.zero:
            new_p = self._gather_zero(new_p)
        for p, n in zip(self._gp, new_p):
            p.copy_(n)
        self._opt_state = new_s
        return loss, ok

    def _gather_zero(self, new_p):
        """ZeRO-1: the updated weight shards of every rank, all-gathered
        and cut back to each parameter's own leading dim."""
        pads = self._zero_pad0
        cov = [i for i, pad0 in enumerate(pads) if pad0 is not None]
        full = collectives.allgather_coalesced(
            [new_p[i] for i in cov], self.batch_axis, self.mesh)
        out = list(new_p)
        for i, w in zip(cov, full):
            out[i] = w[:self._gp[i].shape[0]]
        return out

    # ------------------------------------------------------------------
    # the sync→async ladder (parallel/param_service.py)
    @property
    def sync_mode(self) -> str:
        """The rung in force now: ``"allreduce"`` or ``"async"``
        (``sync="auto"`` moves between them)."""
        return self._applied_sync

    def _named_params(self):
        """The trained parameters by position (the service's keys: names
        may change between builds of a net, positions do not)."""
        return {str(i): p.detach() for i, p in enumerate(self._gp)}

    def attach_param_service(self, service=None, rank: int = 0):
        """Bind the step to a :class:`~.param_service.ParamService` (a new
        one in this process, owned and checkpointed by the step, when
        ``service`` is None) and seed it with the current parameters
        (``init``: rank 0 wins).  Returns the
        :class:`~.param_service.ServiceClient`."""
        from .param_service import ParamService, ServiceClient, \
            ServiceUpdater

        if self.sync == "allreduce":
            raise ValueError(
                "this step was built with sync='allreduce'; rebuild with "
                "make_train_step(sync='async'|'auto') to push/pull "
                "through a parameter service")
        owns = service is None
        if owns:
            service = ParamService(updater=ServiceUpdater(self.opt),
                                   staleness_bound=self.staleness_bound)
        self._svc_client = ServiceClient(service, rank=int(rank),
                                         compressor=self._compression,
                                         owns_service=owns)
        self._svc_client.init_params(self._named_params())
        return self._svc_client

    def set_sync_mode(self, mode: str) -> None:
        """Pin the rung at a step boundary.  Degrading to ``"async"``
        hands the service this replica's current parameters (the service
        holds the authoritative copy from then on); recovering to
        ``"allreduce"`` first takes the service's parameters, so the
        collective rung goes on from the async rung's progress."""
        if mode not in ("allreduce", "async"):
            raise ValueError("sync mode must be 'allreduce' or 'async', "
                             "got %r" % (mode,))
        if self.sync == "allreduce" and mode == "async":
            raise ValueError("step was built with sync='allreduce' — it "
                             "has no async rung")
        if mode == self._applied_sync:
            return
        if mode == "async":
            self._svc_client.sync_params(self._named_params())
        else:
            self._install(self._svc_client.pull_params(
                timeout=self.pull_timeout))
        self._applied_sync = mode
        self.sync_policy.effective = mode

    def observe_stragglers(self, straggler_ranks) -> str:
        """One frame of straggler verdicts (a list of ranks, maybe empty)
        into the ladder: applies any switch the policy decides and returns
        the rung in force.  The supervised loop calls it at every step
        boundary under ``sync="auto"``."""
        mode = self.sync_policy.observe(straggler_ranks)
        if mode != self._applied_sync:
            self.set_sync_mode(mode)
        return self._applied_sync

    def _install(self, pulled):
        """Copy the pulled parameters into the live tensors (and into the
        f32 master copies of a ``multi_precision`` update, which the
        collective rung updates from)."""
        with torch.no_grad():
            for i, p in enumerate(self._gp):
                if str(i) in pulled:
                    p.copy_(pulled[str(i)])
            if self.opt.multi_precision:
                for p, s in zip(self._gp, self._opt_state):
                    _, w32 = self.opt._unpack(s)
                    w32.copy_(p)

    def _async_call(self, x, y):
        """One step on the async rung: forward and backward here, the
        gradients pushed (compressed when set), the parameters pulled
        under the staleness bound and installed.  The counters advance as
        the collective rung's do (the checkpoint schedule and the
        supervisor read the same step count)."""
        self.net.train()
        with torch.enable_grad():
            loss = self._loss(x, y)
            grads = torch.autograd.grad(loss, self._gp, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g.detach()
                     for p, g in zip(self._gp, grads)]
        client = self._svc_client
        client.push_step({str(i): g for i, g in enumerate(grads)})
        pulled = client.pull_params(timeout=self.pull_timeout)
        with torch.no_grad():
            for i, p in enumerate(self._gp):
                p.copy_(pulled[str(i)])
            self._step += 1
        self._step_count += 1
        self._maybe_checkpoint()
        return loss.detach()

    @property
    def loss_scale(self):
        """The current loss scale (reads the device state)."""
        return float(self._scale)

    def boundary_scalars(self, loss):
        """``(loss, applied steps, skipped steps, loss scale)`` as Python
        numbers, read from the device in one copy (what the supervised
        loop reads at every step boundary)."""
        vals = torch.stack([torch.as_tensor(loss).detach().reshape(())
                            .to(self.device, torch.float64),
                            self._step.double(), self._skipped.double(),
                            self._scale.double()]).tolist()
        return vals[0], int(vals[1]), int(vals[2]), vals[3]

    @property
    def skipped_steps(self):
        return int(self._skipped)

    @property
    def step_count(self):
        """Applied updates (skipped steps excluded)."""
        return int(self._step)

    # ------------------------------------------------------------------
    # durable state (parallel/checkpoint.py)
    def _checkpoint_state(self):
        """The training state as the reference's tree: params and aux by
        position, the per-parameter optimizer state, the PRNG key, the
        applied-step counter and the loss-scale state (scale f32,
        unskipped i32, skipped i32).  Under ZeRO-1 over several ranks each
        optimizer-state leaf of a >= 1-d parameter is this rank's
        :class:`~.checkpoint.Shard` of the padded global leaf; a
        parameter sharded by ``param_shardings`` and its state leaves
        are this rank's rows of the global leaf."""
        opt = self._opt_state
        if self.zero and self._n > 1:
            opt = [s if pad0 is None else _tree_map(
                       lambda t, pad0=pad0: self._shard(t, pad0), s)
                   for s, pad0 in zip(opt, self._zero_pad0)]
        params = list(self._gp)
        if self._shards:
            opt = list(opt)
            for i in self._shards:
                params[i] = self._model_shard(i, params[i])
                if self.opt.has_state:
                    opt[i] = _tree_map(
                        lambda t, i=i: self._model_shard(i, t), opt[i])
        state = {"params": params, "aux": list(self._aux),
                 "opt_state": opt, "rng_key": self._rng_key,
                 "step": self._step,
                 "loss_scale": (self._scale, self._unskipped, self._skipped)}
        if self._svc_client is not None:
            # the async rung's durable state: the compressor's residuals
            # (and sparse step counters), the staleness clock and, where
            # the step owns its service, the server's parameters and
            # updater state
            state["param_service"] = self._svc_client.state_dict()
        return state

    def _model_shard(self, i, t):
        """This rank's part ``t`` of the parameter ``i`` sharded over a
        model axis (or of one of its optimizer-state leaves) as a
        checkpoint block: written by the rank at the same place on that
        axis and at 0 on every other."""
        axis, dim = self._shards[i]
        if dim != 0:
            raise NotImplementedError(
                "checkpoints of a parameter sharded on dim %d: the port's "
                "checkpoint blocks are rows (dim 0)" % dim)
        mesh = self.mesh
        n, r = mesh.shape[axis], mesh.axis_index(axis)
        rows = t.shape[0]
        return _ckpt.Shard(t, (rows * n,) + tuple(t.shape[1:]),
                           (r * rows, (r + 1) * rows), r, n,
                           spec="PartitionSpec(%r,)" % axis,
                           owner=mesh.rank_of({axis: r}))

    def _shard(self, t, pad0):
        """This rank's rows ``t`` of a ZeRO-1 leaf padded to ``pad0``."""
        rows = pad0 // self._n
        return _ckpt.Shard(t, (pad0,) + tuple(t.shape[1:]),
                           (self._rank * rows, (self._rank + 1) * rows),
                           self._rank, self._n,
                           spec="PartitionSpec(%r,)" % self.batch_axis,
                           owner=self._zero_owner())

    def _zero_owner(self):
        """The process that writes this rank's ZeRO-1 block: this one
        (None) on a data-parallel mesh; on a mesh with model axes, whose
        ranks hold copies, the one at 0 on every axis but the batch
        axis."""
        if len(self.mesh.axis_names) == 1:
            return None
        return self.mesh.rank_of({self.batch_axis: self._rank})

    @staticmethod
    def _as_manager(directory_or_manager, keep_last=3):
        if isinstance(directory_or_manager, _ckpt.CheckpointManager):
            return directory_or_manager
        return _ckpt.CheckpointManager(directory_or_manager,
                                       keep_last=keep_last)

    def _topology(self):
        """This step's training topology, stamped into every checkpoint's
        meta as the reference stamps it."""
        from .distributed import process_count

        mesh = None if self.mesh is None else dict(self.mesh.shape)
        return {"mesh": mesh, "batch_axis": self.batch_axis,
                "zero": self.zero, "pipeline_stages": self.pipeline_stages,
                "processes": process_count()}

    def _elastic_policy(self):
        """A tree congruent with :meth:`_checkpoint_state`: ``None`` where
        a leaf must keep its saved shape, the logical leading dim where
        the reference pads the optimizer state of a >= 1-d parameter
        (ZeRO-1), whatever this step's own ``zero``: a checkpoint padded
        for any dp width restores here, and this step's is re-padded
        elsewhere."""
        marks = [int(p.shape[0]) if p.dim() >= 1 and i not in self._shards
                 else None for i, p in enumerate(self._gp)]
        opt = [tuple(m for _ in s) if isinstance(s, tuple) else m
               for s, m in zip(self._opt_state, marks)]
        policy = {"params": [None] * len(self._gp),
                  "aux": [None] * len(self._aux), "opt_state": opt,
                  "rng_key": None, "step": None,
                  "loss_scale": (None, None, None)}
        if self._svc_client is not None:
            # exact shapes: the async rung has no mesh, nothing re-pads
            policy["param_service"] = _none_tree(
                self._svc_client.state_dict())
        return policy

    def save_checkpoint(self, directory_or_manager, keep_last=3,
                        data_iter=None):
        """Atomically checkpoint the whole training state; returns the
        committed directory.  ``data_iter`` (default: the iterator bound
        by :meth:`attach_checkpoint`) — its ``state_dict()`` rides the
        manifest, so :meth:`restore_checkpoint` resumes the data stream
        at the exact next batch.  Over a mesh that spans processes every
        rank calls it with the same directory (the module docstring)."""
        mgr = self._as_manager(directory_or_manager, keep_last)
        if data_iter is None:
            data_iter = self._ckpt_data_iter
        meta = {"topology": self._topology()}
        if data_iter is not None:
            meta["data_iter"] = data_iter.state_dict()
        return mgr.save(int(self._step), self._checkpoint_state(), meta=meta)

    def restore_checkpoint(self, directory_or_manager, step=None,
                           data_iter=None):
        """Restore params, running stats, optimizer state, PRNG key, step
        counter and loss scale from the newest intact checkpoint (or
        ``step=``), each copied in place into the live tensor on the
        step's device; returns the restored step number.  Training then
        continues bit-identically to the uninterrupted run.

        ``data_iter`` — restore the data stream too.  Raises
        :class:`~.checkpoint.CheckpointError` when the checkpoint carries
        no iterator state (resuming would replay the epoch); an iterator
        bound by :meth:`attach_checkpoint` only warns then.  A checkpoint
        with iterator state restored without an iterator warns.

        Elastic: a checkpoint saved at another dp width, process count or
        ``zero`` mode restores bit for bit (ZeRO leaves cut and padded
        again, iterator states re-split over this run's processes); what
        cannot be re-sharded raises
        :class:`~.checkpoint.CheckpointTopologyError` naming both
        topologies."""
        mgr = self._as_manager(directory_or_manager)
        live = self._checkpoint_state()
        step_no, state, meta = mgr.restore(
            live, step=step, return_meta=True,
            elastic=self._elastic_policy(), topology=self._topology())
        saved_topo = (meta or {}).get("topology")
        explicit_iter = data_iter is not None
        if data_iter is None:
            data_iter = self._ckpt_data_iter
        if data_iter is not None:
            iter_state = self._resolve_iter_state(meta, saved_topo)
            if iter_state is None:
                msg = ("checkpoint step %d carries no data-iterator state "
                       "(saved without data_iter=) — restoring this "
                       "iterator would silently replay the epoch from "
                       "batch 0; re-save with save_checkpoint(..., "
                       "data_iter=it) or restore without data_iter"
                       % step_no)
                if explicit_iter:
                    raise _ckpt.CheckpointError(msg)
                warnings.warn(msg + " (iterator left untouched)")
            else:
                try:
                    data_iter.load_state_dict(iter_state)
                except (ValueError, KeyError) as e:
                    raise _ckpt.CheckpointTopologyError(
                        "checkpoint step %d: the data iterator refused "
                        "the checkpointed stream state: %s (saved "
                        "topology: %s; current topology: %s)"
                        % (step_no, e, saved_topo, self._topology())) \
                        from e
        elif (meta or {}).get("data_iter") is not None:
            warnings.warn(
                "checkpoint step %d carries data-iterator state but no "
                "data_iter was passed or attached — the data stream "
                "will replay its epoch from batch 0; pass "
                "restore_checkpoint(..., data_iter=it) (or "
                "attach_checkpoint(data_iter=it)) to resume mid-epoch"
                % step_no)
        svc_state = state.pop("param_service", None)
        live.pop("param_service", None)
        pairs = list(zip(_ckpt._flatten(live), _ckpt._flatten(state)))
        for (key, dst), (_, src) in pairs:
            if dst.dtype != src.dtype:
                raise _ckpt.CheckpointTopologyError(
                    "checkpoint step %d: leaf %s is %s, this step's is %s"
                    % (step_no, key, src.dtype, dst.dtype))
        with torch.no_grad():
            for (_, dst), (_, src) in pairs:
                if isinstance(dst, _ckpt.Shard):
                    dst = dst.data
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
                else:
                    np.copyto(dst, src)
        if svc_state is not None:
            self._svc_client.load_state_dict(svc_state)
        self._step_count = int(step_no)
        return step_no

    def _resolve_iter_state(self, meta, saved_topo):
        """This process's share of the checkpointed data-stream state.  A
        multi-process save carries one state per saved process
        (``data_iter_parts``), re-split over this run's processes by
        ``distributed.resplit_iter_state``: verbatim at the same count,
        re-stamped where every part agrees, refused naming both
        topologies where they diverged."""
        from . import distributed as _dist

        parts = (meta or {}).get("data_iter_parts")
        if not parts:
            return (meta or {}).get("data_iter")
        try:
            return _dist.resplit_iter_state(parts, _dist.process_index(),
                                            _dist.process_count())
        except ValueError as e:
            raise _ckpt.CheckpointTopologyError(
                "%s (saved topology: %s; current topology: %s)"
                % (e, saved_topo, self._topology())) from e

    def attach_checkpoint(self, directory_or_manager, every=None,
                          keep_last=3, data_iter=None):
        """Bind a checkpoint manager to the step loop: save at the next
        step boundary whenever a checkpoint request is pending
        (``checkpoint.install_preemption_hook`` / SIGTERM), and every
        ``every`` steps if given.  ``data_iter`` rides every such save.
        Returns the manager."""
        from ..io.io import DataIter

        if every is not None and int(every) < 1:
            raise ValueError("every must be >= 1 or None")
        if data_iter is not None:
            # fail now: an iterator without the state protocol would
            # raise at the preemption save, losing that checkpoint
            sd = getattr(type(data_iter), "state_dict", None)
            if sd is None or sd is DataIter.state_dict:
                raise ValueError(
                    "data_iter=%r does not implement the iterator-state "
                    "protocol (state_dict/load_state_dict) — wrap it in "
                    "io.ResilientIter or use a protocol-aware iterator "
                    "(NDArrayIter, ImageRecordIter, ...) so boundary "
                    "saves can carry the data position"
                    % type(data_iter).__name__)
        self._ckpt_manager = self._as_manager(directory_or_manager,
                                              keep_last)
        self._ckpt_every = int(every) if every else None
        self._ckpt_data_iter = data_iter
        self._ckpt_prev_count = self._step_count
        # requests predating the attach are not ours to honor
        self._ckpt_seen_request = _ckpt.request_seq()
        return self._ckpt_manager

    def _maybe_checkpoint(self):
        """Step-boundary hook: honor a pending checkpoint request, and the
        periodic schedule (off the host step mirror, no device sync),
        against the attached manager."""
        if self._ckpt_manager is None:
            return
        seq = _ckpt.request_seq()
        requested = seq > self._ckpt_seen_request
        due = requested
        if self._ckpt_every:
            prev, cur = self._ckpt_prev_count, self._step_count
            self._ckpt_prev_count = cur
            due = due or prev // self._ckpt_every != cur // self._ckpt_every
        if not due:
            return
        try:
            self.save_checkpoint(self._ckpt_manager)
        except BaseException as e:
            if requested:
                # a failed preemption save: give the signal back its old
                # disposition, so a repeated signal terminates instead of
                # requesting another save that cannot succeed
                warnings.warn(
                    "preemption checkpoint save failed (%s: %s); "
                    "restoring the previous signal disposition so a "
                    "repeated preemption signal terminates instead "
                    "of re-requesting a save that cannot succeed"
                    % (type(e).__name__, e))
                _ckpt.uninstall_preemption_hook()
            else:
                warnings.warn(
                    "periodic checkpoint save failed (%s: %s); the "
                    "last committed checkpoint is unchanged and the "
                    "schedule will retry at the next boundary"
                    % (type(e).__name__, e))
            raise
        self._ckpt_seen_request = seq


def _zero_padded(v, pad0):
    """``v`` with its leading dim zero-padded up to ``pad0`` (itself when
    it already has that size)."""
    if pad0 is None or pad0 == v.shape[0]:
        return v
    return torch.cat([v, v.new_zeros((pad0 - v.shape[0],)
                                     + tuple(v.shape[1:]))])


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _none_tree(tree):
    """``tree`` with every leaf None (dicts, lists and tuples kept)."""
    if isinstance(tree, dict):
        return {k: _none_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_none_tree(v) for v in tree)
    return None


def _check_sync_args(sync, staleness_bound, mesh, pipeline_stages,
                     loss_scale):
    """The reference's refusals of the async rung: one replica a rank
    process (no mesh), no pipeline, no loss scale (pushes are unscaled
    gradients); ``staleness_bound`` only where a service exists."""
    if sync not in ("allreduce", "async", "auto"):
        raise ValueError("sync must be 'allreduce', 'async' or "
                         "'auto', got %r" % (sync,))
    if sync != "allreduce":
        if mesh is not None:
            raise ValueError(
                "sync=%r exchanges gradients through the parameter "
                "service, not through mesh collectives — build the "
                "async-capable step with mesh=None (one replica per "
                "rank process)" % (sync,))
        if pipeline_stages is not None:
            raise ValueError("sync=%r does not compose with "
                             "pipeline_stages" % (sync,))
        if loss_scale is not None:
            raise ValueError(
                "sync=%r pushes unscaled gradients; loss_scale is "
                "not supported on the async rung" % (sync,))
    if staleness_bound is not None:
        if sync == "allreduce":
            raise ValueError(
                "staleness_bound only applies to sync='async'/'auto' "
                "(the bounded-staleness pull clock)")
        if int(staleness_bound) < 0:
            raise ValueError("staleness_bound must be >= 0, got %r"
                             % (staleness_bound,))


def _tree_where(ok, new, old):
    if isinstance(new, (list, tuple)):
        return type(new)(_tree_where(ok, n, o) for n, o in zip(new, old))
    return None if new is None else torch.where(ok, new, old)


def make_train_step(net, loss_fn, optimizer="sgd", compute_dtype=None,
                    loss_scale=None, nonfinite=None, device=None, mesh=None,
                    batch_axis="dp", zero=0, param_shardings=None,
                    pipeline_stages=None, num_micro=1, pipeline_axis="pp",
                    pipeline_remat=False, skip_streak_budget=None,
                    sync="allreduce", staleness_bound=None, compression=None,
                    **opt_kwargs) -> TrainStep:
    """Build the train step (forward + backward + update per call).

    ``optimizer`` is any registered optimizer's name, with its keywords
    (``learning_rate``, ``momentum``, ``wd``, ``multi_precision``,
    ``clip_gradient``, ``rescale_grad``, ``beta1``, ...), see
    :class:`FunctionalOptimizer`.  ``loss_scale`` is None, a positive
    static scale, ``"dynamic"`` or a :class:`DynamicLossScale`.
    ``nonfinite`` is what a step with a non-finite gradient does:
    ``"skip"`` leaves params, running stats, optimizer state and the
    step counter as they were, ``"raise"`` does so and raises
    ``FloatingPointError``, ``"off"`` does not look (the default, but
    ``"skip"`` under a dynamic scale, which needs it).  ``device``
    defaults to the CUDA card and must hold the net's parameters.

    ``mesh`` (:func:`~.mesh.make_mesh`) makes the step one rank of a
    process mesh.  Over its ``batch_axis`` the step is data parallel:
    each process calls it with its slice of the global batch
    (:meth:`~.mesh.Mesh.local_slice`); ``zero=1`` shards the weight
    update over that axis (ZeRO-1, sgd and adam).  ``param_shardings``
    (``{name: P("tp", None)}``) shards a parameter over a model axis:
    each rank keeps its part and that part's optimizer state, and the
    forward all-gathers it (a block with ``takes_shards``, such as
    ``MoEFFN``, gets its part).  ``pipeline_stages=K`` with
    ``num_micro=M`` runs the net's children as K congruent stages over
    the mesh's ``pipeline_axis`` (:func:`~.pipeline.spmd_pipeline`), the
    batch (each dp rank's slice) cut into M microbatches;
    ``pipeline_remat`` recomputes each stage in the backward.

    ``sync`` picks how gradients are exchanged
    (:mod:`.param_service`): ``"allreduce"`` (the step above),
    ``"async"`` (bounded-staleness push/pull through a parameter service
    the step owns: a rank runs at most ``staleness_bound`` steps, default
    4, ahead of the slowest) or ``"auto"`` (allreduce until the
    supervisor's straggler verdicts degrade it, and back:
    :meth:`TrainStep.observe_stragglers`).  The async rungs take no mesh,
    no pipeline and no loss scale.  ``compression`` (``"2bit"``,
    ``"topk"``, ``"randomk"``, ``"int8"`` or a dict such as ``{"kind":
    "topk", "ratio": 0.25}``) compresses the pushes with error feedback;
    the residuals ride the checkpoint.  ``skip_streak_budget`` declares a
    bound on consecutive skipped steps, which
    :func:`~.supervisor.run_supervised` enforces."""
    opt = FunctionalOptimizer(optimizer, **opt_kwargs)
    return TrainStep(net, loss_fn, opt, compute_dtype=compute_dtype,
                     loss_scale=loss_scale, nonfinite=nonfinite,
                     device=device, mesh=mesh, batch_axis=batch_axis,
                     zero=zero, param_shardings=param_shardings,
                     pipeline_stages=pipeline_stages, num_micro=num_micro,
                     pipeline_axis=pipeline_axis,
                     pipeline_remat=pipeline_remat,
                     skip_streak_budget=skip_streak_budget, sync=sync,
                     staleness_bound=staleness_bound,
                     compression=compression)
