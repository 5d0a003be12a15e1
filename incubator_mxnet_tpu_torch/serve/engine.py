"""ServeEngine: bucketed batch-shape inference on the card, one CUDA graph
per bucket (port of ``incubator_mxnet_tpu/serve/engine.py``).

Request batches arrive at every size, and a program per size would be a
capture storm.  As in the reference, programs exist per *bucket* batch
size: a batch of ``n`` rows is zero-padded into the smallest bucket that
holds it and sliced back; a batch over the largest bucket runs in
chunks of it.  The reference compiles one AOT program per bucket; here
a bucket's program is a captured ``torch.cuda.CUDAGraph``:

- :meth:`ServeEngine.warmup` runs every bucket once eagerly (the kernels
  are built, cuDNN and cuBLAS choose their algorithms), then captures
  one graph per bucket with a static input buffer and static outputs
  (``parallel/aot.py::capture_timed``).  ``warmup`` raises when a
  capture fails: nothing falls back to an eager run;
- :meth:`ServeEngine.infer` copies the padded batch into the bucket's
  input buffer, replays the graph, and clones the request's rows out
  before another replay can overwrite them.  A bucket first used after
  warmup is a capture, counted in ``recompile_count`` and warned as the
  reference's GL005;
- the launches each capture made are kept per bucket program
  (``capture_launches``): a replay goes through no Python wrapper, so
  ``_kernels.launch_counts()`` does not move during traffic.

**Two parameter slots.**  A graph reads its parameters at the addresses
it captured, so a swap must write into captured tensors, never rebind
them.  The engine keeps two private copies of the net on the card (the
*slots*), each with its own graph per bucket, and publishes one of them
as live with ``(version, slot)``:

- :meth:`ServeEngine.update_params` writes the candidate into the idle
  slot, canaries it on the idle slot's smallest bucket (non-finite
  output, or with ``canary_tol`` drift from the live slot on the same
  rows, rejects it), and publishes it by flipping the live index.  A
  rejected candidate is no flip: the incumbent's tensors are never
  written, so it keeps serving bitwise unchanged;
- :meth:`ServeEngine.shadow_infer` runs a candidate the same way, on the
  idle slot, without publishing it;
- every replay holds the engine's run lock (the graphs share one memory
  pool, and ``infer`` holds it over all of a call's chunks), and the
  flip takes the same lock: each call is served by exactly one version,
  recorded in ``last_version_served``.  Swaps and shadow runs, which
  write the idle slot, hold the swap lock.  Captures after warmup hold
  the run lock and capture in ``thread_local`` error mode, so a capture
  never overlaps a replay.

On a CPU tensor (``device="cpu"``, as the tests run it) a bucket's
program is the same padded forward run eagerly; everything else is the
same.  The forward is the net's own in predict mode (``eval()``) under
``torch.no_grad()``, so BatchNorm uses its running statistics: the
counterpart of the reference's ``pure_forward(..., training=False)``.

``dtype="bfloat16"`` (any float dtype) is the compute-cast tier: the
slots hold the parameters in that dtype and float requests are cast to
it inside the program.  The candidate's signature is the net's own
``(name, shape, dtype)``, pinned at warmup; a candidate that drifts
from it in names, shapes or dtypes is refused eagerly with
:class:`LintError` (the reference's GL011), before anything is written.

``dtype="int8"`` is the weight-only quantized tier (the reference's
``quantize_int8`` graftpass, ``analysis/passes.py:707``): every floating
parameter of ndim >= 2 (convolution filters, dense weights) is held in
each slot only as int8 codes and a 0-d f32 amax
(``ops/quantization.quantize_tensor``), quantized on the engine's device
at load and again for each swap or shadow candidate; biases, BN vectors
and running statistics stay float.  The slot's net holds no float copy of
those tensors (its own are ``meta`` tensors).  Each bucket program
dequantizes the codes in its prologue with the reference's arithmetic,
``(q.float() * (amax / 127)).to(dtype)``, and runs the net on them
through ``torch.func.functional_call``; the tier has no compute cast.
``_p_vals``/``_quantized`` are the reference's per-parameter values
(a ``(codes, amax)`` pair where quantized) and int8 flags.

Not ported: the ``lint=``, ``cost=``, ``numerics=``, ``passes=``,
``hbm_budget=``, ``cost_device=`` and ``lint_suppress=`` hooks and
``schedule_hash`` (they walk jaxprs), and ``mesh=``/``batch_axis=``/
``param_shardings=`` (the reference's mesh is one program over the
devices of one process).
"""
from __future__ import annotations

import copy
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from .. import _kernels, base, context
from ..ndarray import NDArray
from ..ops.quantization import dequantize_tensor, quantize_tensor
from ..parallel.aot import capture_timed

__all__ = ["LintError", "ServeEngine"]


class LintError(ValueError):
    """An eager gate refused the call (the reference's
    ``analysis.LintError``); ``code`` names the reference's diagnostic,
    ``GL011`` for a swap candidate that drifts from the served
    signature."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__("%s: %s" % (code, message))


def _sig_dtype(dtype):
    """``dtype`` as the numpy dtype the reference's signature holds, or
    the torch dtype where numpy has none (bfloat16)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return dtype
        return np.dtype(base.dtype_name(dtype))
    return np.dtype(dtype)


def tree_map(fn, tree):
    """``fn`` over the tensors of a net's output (a tensor, or tuples,
    lists and dicts of them)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_cat(trees):
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_cat([t[i] for t in trees])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees]) for k in first}
    return torch.cat(trees, dim=0)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def check_swap_compatibility(served, candidate, missing=(), extra=()):
    """The reference's GL011 core: the drifts of a candidate's
    ``(name, shape, dtype)`` list from the served one, as one message,
    or None."""
    served, candidate = list(served), list(candidate)
    drifts = []
    if len(candidate) != len(served):
        drifts.append("param count %d -> %d" % (len(served),
                                                len(candidate)))
    for (name, s_shape, s_dtype), (_n, c_shape, c_dtype) in zip(served,
                                                                candidate):
        if c_shape is None:
            continue  # tree-level drift, reported via missing/extra
        if tuple(c_shape) != tuple(s_shape):
            drifts.append("%s: shape %s -> %s"
                          % (name, tuple(s_shape), tuple(c_shape)))
        if c_dtype != s_dtype:
            drifts.append("%s: dtype %s -> %s" % (name, s_dtype, c_dtype))
    for n in missing:
        drifts.append("%s: missing from candidate" % n)
    for n in extra:
        drifts.append("%s: not in the served tree" % n)
    if not drifts:
        return None
    show = "; ".join(drifts[:6])
    more = "" if len(drifts) <= 6 else " (+%d more)" % (len(drifts) - 6)
    return ("swap candidate drifts from the served param signature in %d "
            "place(s): %s%s -- same shapes/dtypes are the zero-capture "
            "contract; this swap would re-capture every bucket program "
            "under live traffic" % (len(drifts), show, more))


def _owner(net, path):
    """``(module, attribute)`` that holds the tensor at ``path``."""
    *parents, attr = path.split(".")
    mod = net
    for p in parents:
        mod = getattr(mod, p)
    return mod, attr


class _Slot:
    """One private copy of the net on the engine's device, in predict
    mode and the engine's compute dtype, with its values in the
    reference's ``collect_params()`` order: a tensor, or for a quantized
    parameter its ``(int8 codes, 0-d f32 amax)`` pair, whose float tensor
    in the net is replaced by a ``meta`` tensor (no storage)."""

    def __init__(self, net, paths, device, compute, quantized):
        self.net = copy.deepcopy(net).to(device)
        if compute is not None:
            self.net.to(compute)
        self.net.eval()
        self.net.requires_grad_(False)
        lookup = dict(self.net.named_parameters(remove_duplicate=False))
        lookup.update(self.net.named_buffers(remove_duplicate=False))
        self.values: List[Any] = []
        #: (path, (codes, amax), float dtype) per quantized parameter
        self.quant: List[tuple] = []
        gone = {}
        for path, q in zip(paths, quantized):
            t = lookup[path]
            if not q:
                self.values.append(t)
                continue
            pair = (torch.zeros(t.shape, dtype=torch.int8, device=device),
                    torch.zeros((), dtype=torch.float32, device=device))
            self.values.append(pair)
            self.quant.append((path, pair, t.dtype))
            meta = torch.nn.Parameter(
                torch.empty(t.shape, dtype=t.dtype, device="meta"),
                requires_grad=False)
            mod, attr = _owner(self.net, path)
            if attr in mod._parameters:
                mod._parameters[attr] = meta
            else:
                mod._buffers[attr] = meta.data
            gone[id(t)] = meta
        if gone:
            # the Gluon Parameters of the copy would keep the float tensors
            for p in self.net.collect_params().values():
                if id(p._tensor) in gone:
                    p._var._data = gone[id(p._tensor)]

    def load(self, raw):
        """Write one version's values into this slot, in place (the
        addresses the slot's graphs captured stay); a quantized
        parameter is quantized on the slot's device first."""
        with torch.no_grad():
            for v, a in zip(self.values, raw):
                src = a if isinstance(a, torch.Tensor) else \
                    torch.from_numpy(np.ascontiguousarray(a))
                if isinstance(v, tuple):
                    codes, amax = quantize_tensor(src.to(v[0].device))
                    v[0].copy_(codes)
                    v[1].copy_(amax)
                else:
                    v.copy_(src)

    def forward(self, x):
        """The net on ``x``; quantized parameters dequantized first."""
        if not self.quant:
            return self.net(x)
        deq = {path: dequantize_tensor(codes, amax, dt)
               for path, (codes, amax), dt in self.quant}
        return torch.func.functional_call(self.net, deq, (x,))

    @property
    def nbytes(self) -> int:
        """Bytes of this slot's parameter values on the device."""
        return sum(t.numel() * t.element_size() for v in self.values
                   for t in (v if isinstance(v, tuple) else (v,)))


class _Program:
    """One bucket's inference program over one slot: a captured CUDA
    graph with its static input and outputs, or on the CPU the same
    padded forward run eagerly."""

    def __init__(self, engine, slot, bucket):
        self.bucket = bucket
        self._engine = engine
        self._slot = slot
        self.x = torch.zeros((bucket,) + engine.sample_shape,
                             dtype=engine._sample_torch, device=engine.device)
        self.graph = None
        self.out = None
        self.launches: Dict[str, int] = {}
        self.times = {"eager": 0.0, "capture": 0.0}

    def build(self):
        eng = self._engine
        t0 = time.perf_counter()
        eng._forward(self._slot, self.x)  # the eager pass
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        self.times["eager"] = time.perf_counter() - t0
        if eng.device.type != "cuda":
            return
        before = _kernels.launch_counts()
        with torch.cuda.device(eng.device):
            self.graph, self.out, t = capture_timed(
                eng._forward, self._slot, self.x, pool=eng._pool)
        after = _kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.times["capture"] = t["capture"]

    def run(self, x):
        """The program on ``x`` (at most ``bucket`` rows): its rows copied
        in, the rest zeros; returns fresh tensors of ``x``'s rows."""
        k = x.shape[0]
        self.x[:k].copy_(x)
        if k < self.bucket:
            self.x[k:].zero_()
        if self.graph is None:
            out = self._engine._forward(self._slot, self.x)
        else:
            self.graph.replay()
            out = self.out
        return tree_map(lambda a: a[:k].clone(), out)


class ServeEngine:
    """Bucketed inference over a Gluon net (module note).

    Usage::

        engine = ServeEngine(net, buckets=(8, 32))
        engine.warmup(np.zeros((3, 32, 32), np.float32))  # one sample
        out = engine.infer(batch)      # any batch size

    ``buckets`` are the batch sizes programs exist for.  ``warmup``
    captures every bucket; after it ``recompile_count`` must stay 0.
    ``device`` is where the engine serves (``None``: the card; ``"cpu"``
    runs the programs eagerly).  ``dtype`` is None (the net's own), a
    float dtype (the compute-cast tier) or ``"int8"`` (the weight-only
    quantized tier, module note)."""

    def __init__(self, net, buckets: Sequence[int] = (1, 8, 32),
                 dtype: Optional[str] = None, device=None):
        self.net = net
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or any(b < 1 for b in self.buckets):
            raise ValueError("buckets must be positive batch sizes, got %r"
                             % (buckets,))
        if len(set(self.buckets)) != len(self.buckets):
            raise ValueError("duplicate buckets in %r" % (buckets,))
        self._int8 = dtype == "int8"
        self._compute = None
        if dtype is not None and not self._int8:
            # a float dtype is a compute cast (the bf16 serving tier)
            self._compute = base.torch_dtype(dtype)
            if not self._compute.is_floating_point:
                raise ValueError("dtype must be a float dtype, got %r"
                                 % (dtype,))
        self.dtype = dtype
        self.device = context.resolve(device)
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self._params: List[Any] = []       # the net's Parameter objects
        self._param_sig: List[tuple] = []  # (name, shape, dtype) pinned
        self._quantized: List[bool] = []   # per-param int8 flag
        self._slots: List[_Slot] = []
        # the published state: (version, live slot), one tuple
        self._state: Tuple[int, int] = (0, 0)
        self._programs: Dict[Tuple[int, int], _Program] = {}
        self.capture_log: Dict[int, Dict[str, float]] = {}
        self._warm = False
        self._run_lock = threading.RLock()
        self._swap_lock = threading.Lock()
        self.sample_shape: Optional[tuple] = None
        self.sample_dtype = None
        self._sample_torch = None
        # serving counters (the loadtest report reads these)
        self.recompile_count = 0
        self.infer_calls = 0
        self.rows_served = 0
        self.padded_rows = 0
        # hot-swap counters
        self.swap_count = 0
        self.rollback_count = 0
        self.swap_log: List[Dict[str, Any]] = []
        self.last_version_served: Optional[int] = None

    # ------------------------------------------------------------------
    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    @property
    def params_version(self) -> int:
        """The served param version (1 after warmup; +1 per committed
        :meth:`update_params`)."""
        return self._state[0]

    @property
    def _live(self) -> Tuple[int, List[Any]]:
        """``(version, values)`` of the live slot: a tensor per parameter,
        a ``(codes, amax)`` pair where quantized."""
        ver, slot = self._state
        return ver, (self._slots[slot].values if self._slots else [])

    @property
    def _p_vals(self) -> List[Any]:
        """The served values of the live version (the reference's test
        hook)."""
        return self._live[1]

    @property
    def resident_bytes(self) -> int:
        """Bytes of one slot's parameter values on the device."""
        return self._slots[0].nbytes if self._slots else 0

    @property
    def param_signature(self) -> List[tuple]:
        """``(name, shape, dtype)`` per served parameter: the pinned
        signature every swap candidate must match (GL011)."""
        return list(self._param_sig)

    @property
    def capture_launches(self) -> Dict[Tuple[int, int], Dict[str, int]]:
        """Kernel launches each capture made, by ``(slot, bucket)``."""
        return {k: dict(p.launches) for k, p in self._programs.items()}

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` rows (the padding target)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_bucket

    # ------------------------------------------------------------------
    def _collect(self):
        if self._slots:
            return
        params = list(self.net.collect_params().values())
        tensors = [p._tensor for p in params]
        if any(t is None or is_lazy(t) for t in tensors):
            raise RuntimeError("initialize() the net (and run one forward "
                               "for deferred shapes) before serving it")
        path_of = {id(t): n for n, t in
                   self.net.named_parameters(remove_duplicate=False)}
        path_of.update({id(t): n for n, t in
                        self.net.named_buffers(remove_duplicate=False)})
        paths = [path_of[id(t)] for t in tensors]
        self._params = params
        self._param_sig = [(p.name, tuple(t.shape), _sig_dtype(t.dtype))
                           for p, t in zip(params, tensors)]
        self._quantized = self._quant_layout(tensors)
        self._slots = [_Slot(self.net, paths, self.device, self._compute,
                             self._quantized) for _ in range(2)]
        if any(self._quantized):
            for slot in self._slots:
                slot.load(tensors)
        self._state = (1, 0)

    def _quant_layout(self, values):
        """Per value (a tensor or an array), whether the int8 tier
        quantizes it: floating with ndim >= 2
        (``analysis/passes.py:740-749``); all False off the tier."""
        return [self._int8 and v.ndim >= 2 and (
            v.is_floating_point() if isinstance(v, torch.Tensor)
            else np.issubdtype(v.dtype, np.floating)) for v in values]

    def _param_dtype(self):
        """The dtype an unsigned-integer request is promoted to."""
        if self._compute is not None:
            return self._compute
        for _n, _s, d in self._param_sig:
            t = d if isinstance(d, torch.dtype) else base.torch_dtype(d)
            if t.is_floating_point:
                return t
        return torch.float32

    def _forward(self, slot, x):
        """The inference forward of one slot on a padded batch."""
        if not x.dtype.is_floating_point and not x.dtype.is_signed \
                and x.dtype != torch.bool:
            # raw image bytes: promoted as the train step does
            x = x.to(self._param_dtype())
        elif self._compute is not None and x.is_floating_point():
            x = x.to(self._compute)
        with torch.no_grad():
            return self._slots[slot].forward(x)

    def _ensure_bucket(self, bucket, warming=False):
        """The programs of ``bucket`` for both slots, built (eager pass,
        then capture) where missing; a build after warmup is counted and
        warned (GL005)."""
        if (0, bucket) in self._programs:
            return
        with self._run_lock:
            if (0, bucket) in self._programs:
                return
            if self._warm and not warming:
                self.recompile_count += 1
                warnings.warn(
                    "GL005: post-warmup capture for bucket %d -- the "
                    "request path hit a shape the warmup never captured; "
                    "steady-state serving must be capture-free (warmup() "
                    "every bucket the batcher can emit before opening "
                    "traffic)" % bucket, stacklevel=4)
            times = {"eager": 0.0, "capture": 0.0}
            for slot in range(len(self._slots)):
                prog = _Program(self, slot, bucket)
                prog.build()
                self._programs[(slot, bucket)] = prog
                for k in times:
                    times[k] += prog.times[k]
            self.capture_log[bucket] = times

    def warmup(self, sample, buckets: Optional[Sequence[int]] = None
               ) -> Dict[str, float]:
        """Capture the program table for ``buckets`` (default: all).

        ``sample`` is ONE request payload (no batch dim): it pins the
        per-sample shape and dtype every later request must match.
        Returns ``{"eager": s, "capture": s}``, the seconds this call
        spent in eager passes and in captures.  After warmup the engine
        is in the steady-state regime: ``recompile_count`` stays 0."""
        sample = self._as_numpy(sample)
        if self.sample_shape is not None and (
                tuple(sample.shape) != self.sample_shape
                or np.dtype(sample.dtype) != np.dtype(self.sample_dtype)):
            raise ValueError(
                "warmup sample %s/%s disagrees with the engine's pinned "
                "sample %s/%s -- one engine serves one signature"
                % (sample.shape, sample.dtype, self.sample_shape,
                   self.sample_dtype))
        self.sample_shape = tuple(sample.shape)
        self.sample_dtype = np.dtype(sample.dtype)
        self._sample_torch = base.torch_dtype(self.sample_dtype)
        self._collect()
        total = {"eager": 0.0, "capture": 0.0}
        for b in (self.buckets if buckets is None
                  else sorted(set(int(x) for x in buckets))):
            if b not in self.buckets:
                raise ValueError("bucket %d is not in this engine's "
                                 "buckets %s" % (b, self.buckets))
            fresh = (0, b) not in self._programs
            # a staged warmup (a second call covering buckets the first
            # skipped) is still warmup, not a steady-state capture
            self._ensure_bucket(b, warming=True)
            if fresh:
                for k in total:
                    total[k] += self.capture_log[b][k]
        self._warm = True
        return total

    # ------------------------------------------------------------------
    @staticmethod
    def _as_numpy(x):
        if isinstance(x, NDArray):
            return x.asnumpy()
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def _rows(self, x, what="request"):
        """``x`` as a tensor of rows, checked against the pinned sample."""
        if isinstance(x, NDArray):
            x = x._data
        if isinstance(x, torch.Tensor):
            shape, dt = tuple(x.shape[1:]), x.dtype
            ok_dtype = dt == self._sample_torch
        else:
            x = np.asarray(x)
            shape, dt = tuple(x.shape[1:]), x.dtype
            ok_dtype = np.dtype(dt) == self.sample_dtype
        if shape != self.sample_shape:
            raise ValueError("%s rows have shape %s, engine serves %s"
                             % (what, shape, self.sample_shape))
        if not ok_dtype:
            raise ValueError("%s dtype %s, engine serves %s"
                             % (what, dt, self.sample_dtype))
        if x.shape[0] == 0:
            raise ValueError("empty %s batch" % what)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x

    def _run_chunks(self, slot, x, bucket=None):
        """``x`` through ``slot``'s programs in chunks of the largest
        bucket (or of ``bucket``); the caller holds the run lock."""
        step = bucket or self.max_bucket
        outs = []
        for off in range(0, x.shape[0], step):
            chunk = x[off:off + step]
            k = chunk.shape[0]
            b = bucket or self.bucket_for(k)
            self._ensure_bucket(b)
            if k != b and bucket is None:
                self.padded_rows += b - k
            outs.append(self._programs[(slot, b)].run(chunk))
        return outs[0] if len(outs) == 1 else _tree_cat(outs)

    def infer(self, x):
        """Serve one request batch ``(n, *sample_shape)``: padded into its
        bucket and sliced back to ``n`` rows; batches over the largest
        bucket run as chunks.  Returns tensors on the engine's device.

        The live version is read once per call and the run lock is held
        over all of its chunks: every row of this batch is served by
        exactly one version even while :meth:`update_params` swaps; the
        version is recorded in ``last_version_served``."""
        if self.sample_shape is None:
            raise RuntimeError("warmup() the engine before serving "
                               "(it pins the request signature)")
        xt = self._rows(x)
        with self._run_lock:
            ver, slot = self._state
            self.infer_calls += 1
            self.rows_served += xt.shape[0]
            out = self._run_chunks(slot, xt)
            self.last_version_served = ver
        return out

    # ------------------------------------------------------------------
    def _normalize_candidate(self, new_params):
        """Candidate -> ordered raw arrays + ``(name, shape, dtype)``
        descriptors.  Accepts a list/tuple in the engine's param order
        or a dict keyed by parameter name; missing/extra names are tree
        drift (GL011)."""
        names = [s[0] for s in self._param_sig]
        extra = []
        if isinstance(new_params, dict):
            name_set = set(names)
            extra = [n for n in new_params if n not in name_set]
            ordered = [new_params.get(n) for n in names]
        else:
            ordered = list(new_params)
            if len(ordered) > len(names):
                extra = ["<positional %d..%d>" % (len(names),
                                                  len(ordered))]
            ordered = (ordered + [None] * len(names))[:len(names)]
        missing = [n for n, v in zip(names, ordered) if v is None]
        raw, cand_sig = [], []
        for name, v in zip(names, ordered):
            if v is None:
                raw.append(None)
                cand_sig.append((name, None, None))
                continue
            if isinstance(v, NDArray):
                v = v._data
            if isinstance(v, torch.Tensor):
                a = v.detach()
                dt = _sig_dtype(a.dtype)
            else:
                a = np.asarray(v)
                dt = np.dtype(a.dtype)
            raw.append(a)
            cand_sig.append((name, tuple(a.shape), dt))
        return raw, cand_sig, missing, extra

    def _checked_candidate(self, new_params, where):
        """The candidate's arrays, or :class:`LintError` (GL011) on any
        drift: the eager gate, before anything is written."""
        raw, cand_sig, missing, extra = self._normalize_candidate(new_params)
        msg = check_swap_compatibility(self._param_sig, cand_sig,
                                       missing=missing, extra=extra)
        if msg is not None:
            raise LintError("GL011", "%s [%s]" % (msg, where))
        if self._quant_layout(raw) != self._quantized:
            # unreachable past GL011; kept as the reference keeps it
            raise RuntimeError("candidate quantization layout drifted from "
                               "the served one")
        return raw

    def _warmed(self):
        return [b for b in self.buckets if (0, b) in self._programs]

    def shadow_infer(self, x, candidate=None):
        """Run a batch through an existing bucket program against
        ``candidate`` params (or the live version when ``None``) without
        publishing anything.  The candidate goes into the idle slot (the
        live one is never written) and passes the same GL011 gate as
        :meth:`update_params`.  No capture, and ``infer_calls``,
        ``rows_served`` and ``last_version_served`` do not move.
        Returns the net's output, sliced to the request rows."""
        if self.sample_shape is None:
            raise RuntimeError("warmup() the engine before shadow_infer() "
                               "-- it replays captured bucket programs")
        xt = self._rows(x, "shadow")
        warmed = self._warmed()
        if not warmed:
            raise RuntimeError("no captured bucket program to shadow on "
                               "-- warmup() first")
        with self._swap_lock:
            if candidate is not None:
                raw = self._checked_candidate(
                    candidate, "ServeEngine(%s).shadow_infer" % self.net.name)
                idle = 1 - self._state[1]
                self._slots[idle].load(raw)
            with self._run_lock:
                slot = self._state[1] if candidate is None \
                    else 1 - self._state[1]
                return self._run_chunks(slot, xt, bucket=warmed[-1])

    def update_params(self, new_params, canary=None,
                      canary_tol: Optional[float] = None,
                      context: Optional[str] = None) -> int:
        """Swap the served param version under live traffic (module
        note).

        ``new_params``: arrays in the engine's parameter order, or a dict
        keyed by parameter name.  Any name, shape or dtype drift from
        :attr:`param_signature` raises :class:`LintError` (GL011) before
        anything is written.  The candidate is written into the idle
        slot and canaried on its smallest captured bucket with
        ``canary`` (rows of the sample shape; default zeros): non-finite
        output, or with ``canary_tol`` a max-abs drift beyond
        ``canary_tol * max|live output|``, rolls it back with
        :class:`~.resilience.SwapRejected`, and the live slot keeps
        serving, untouched.  Otherwise the idle slot is published (one
        flip under the run lock) and the new version number returned.
        ``context`` names an automated caller; it is accepted for the
        reference's signature and ignored until the lint layer brings
        its GL014 warning."""
        from .resilience import SwapRejected

        with self._swap_lock:
            if not self._slots or self.sample_shape is None:
                raise RuntimeError(
                    "warmup() the engine before update_params() -- the "
                    "canary replays a captured bucket program, and the "
                    "pinned signature is what GL011 validates against")
            raw = self._checked_candidate(
                new_params, "ServeEngine(%s).update_params" % self.net.name)
            warmed = self._warmed()
            if not warmed:
                raise RuntimeError("no captured bucket program to canary "
                                   "on -- warmup() first")
            bucket = warmed[0]
            if canary is None:
                cx = torch.zeros((bucket,) + self.sample_shape,
                                 dtype=self._sample_torch)
            else:
                cx = self._as_numpy(canary)
                if cx.ndim == len(self.sample_shape):
                    cx = cx[None]
                if tuple(cx.shape[1:]) != self.sample_shape or \
                        np.dtype(cx.dtype) != self.sample_dtype:
                    raise ValueError(
                        "canary rows %s/%s do not match the engine's "
                        "sample %s/%s" % (tuple(cx.shape[1:]), cx.dtype,
                                          self.sample_shape,
                                          self.sample_dtype))
                cx = torch.from_numpy(np.ascontiguousarray(cx[:bucket]))
            old_ver, live = self._state
            idle = 1 - live
            self._slots[idle].load(raw)
            with self._run_lock:
                new_out = self._programs[(idle, bucket)].run(cx)
            new_leaves = [a.double().cpu() for a in _leaves(new_out)]
            reason = None
            if not all(bool(torch.isfinite(a).all()) for a in new_leaves):
                reason = ("canary produced non-finite output "
                          "(poisoned/corrupt candidate weights)")
            elif canary_tol is not None:
                with self._run_lock:
                    ref_out = self._programs[(live, bucket)].run(cx)
                ref_leaves = [a.double().cpu() for a in _leaves(ref_out)]
                drift = max(float((n - r).abs().max()) if n.numel() else 0.0
                            for n, r in zip(new_leaves, ref_leaves))
                scale = max(float(r.abs().max()) if r.numel() else 0.0
                            for r in ref_leaves)
                if drift > float(canary_tol) * (scale + 1e-12):
                    reason = ("canary drift %.3g exceeds tolerance %.3g "
                              "x live-output scale %.3g"
                              % (drift, float(canary_tol), scale))
            if reason is not None:
                self.rollback_count += 1
                self.swap_log.append({"version": old_ver + 1, "ok": False,
                                      "reason": reason, "t": time.time()})
                raise SwapRejected(reason)
            with self._run_lock:   # publish: one flip between replays
                self._state = (old_ver + 1, idle)
            self.swap_count += 1
            self.swap_log.append({"version": old_ver + 1, "ok": True,
                                  "reason": "", "t": time.time()})
            return old_ver + 1
