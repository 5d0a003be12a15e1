"""Gradient compression with error feedback (port of
``incubator_mxnet_tpu/kvstore/gradient_compression.py``; the reference's
``src/kvstore/gradient_compression.h``).

Each compressor maps a gradient to a smaller wire payload and banks what
it left out (the quantization or sparsification residual) into the next
step's gradient, so nothing is lost over time.  The payloads are what the
parameter service (``parallel/param_service.py``) receives per push and
what ``dist_async`` sends to its host.

- :class:`GradientCompression` — the reference's 2-bit ternary
  compressor: each element becomes one of ``{-t, 0, +t}``; dense wire
  format (decompression is the identity).
- :class:`TopKCompressor` — keep the ``ratio`` fraction of the
  largest-|g| elements per tensor; wire format (int32 indices, f32
  values).
- :class:`RandomKCompressor` — keep k elements at positions drawn by a
  ``torch.Generator`` seeded from ``(seed, crc32(key), step)``: no
  data-dependent selection, and every process draws the same positions
  for the same key and step.
- :class:`Int8Compressor` — symmetric int8 codes scaled by the tensor's
  largest magnitude (the reference's ``symmetric_quantize``, kept here),
  4x smaller than f32.

Every compressor keeps its residuals (and the sparse ones their per-key
step counters) behind ``state_dict()``/``load_state_dict()``, so a
checkpoint carries them and kill-and-resume loses nothing.  Everything
runs as tensor ops on the gradient's device.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np
import torch

from ..base import dtype_name, torch_dtype

__all__ = ["GradientCompression", "TopKCompressor", "RandomKCompressor",
           "Int8Compressor", "make_compressor", "decompress_payload"]


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    if hasattr(value, "_data") and isinstance(value._data, torch.Tensor):
        return value._data  # an NDArray
    return torch.as_tensor(np.asarray(value))


class _ErrorFeedback:
    """The residual store and its checkpoint protocol."""

    def __init__(self):
        self._residual: Dict[str, torch.Tensor] = {}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The residuals by push key (tensors on their device)."""
        return {k: v for k, v in sorted(self._residual.items())}

    def load_state_dict(self, state: Dict) -> None:
        """Restore residuals saved by :meth:`state_dict`."""
        if state is None:
            return
        self._residual = {str(k): _as_tensor(v)
                          for k, v in dict(state).items()}

    def reset_state(self) -> None:
        self._residual = {}

    def _carry_in(self, key, grad):
        """``grad`` plus the residual banked for ``key``."""
        r = self._residual.get(key)
        if r is None:
            return grad
        return grad + r.to(device=grad.device, dtype=grad.dtype)


class GradientCompression(_ErrorFeedback):
    """The reference's 2-bit ternary compressor (dense wire format)."""

    kind = "2bit"

    def __init__(self, type="2bit", threshold=0.5):  # noqa: A002
        if str(type) != "2bit":
            raise ValueError(
                "only 2bit compression is supported "
                "(gradient_compression.h kGradientCompression2Bit)")
        super().__init__()
        self.type = str(type)
        self.threshold = float(threshold)

    def compress(self, key, grad):
        """``grad`` (plus the residual) as ternary ``{-t, 0, +t}``; the
        difference is banked (``Quantize2Bit``)."""
        t = self.threshold
        grad = _as_tensor(grad)
        g = self._carry_in(key, grad)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        tt = torch.full((), t, dtype=g.dtype, device=g.device)
        q = torch.where(g >= t, tt, torch.where(g <= -t, -tt, zero))
        q = q.to(grad.dtype)
        self._residual[key] = g - q
        return q

    def decompress(self, key, q):
        """The identity: ``q`` already holds the ternary values."""
        return q

    def payload_nbytes(self, shape, dtype) -> int:
        return -(-int(np.prod(shape, dtype=np.int64)) // 4)


def _k_of(shape, ratio) -> int:
    n = int(np.prod(shape, dtype=np.int64))
    return max(1, min(n, int(np.ceil(n * ratio))))


class _SparseCompressor(_ErrorFeedback):
    """Top-k and random-k: sparse (indices, values) payloads with error
    feedback and per-key step counters."""

    def __init__(self, ratio=0.01):
        super().__init__()
        if not 0.0 < float(ratio) <= 1.0:
            raise ValueError("ratio must be in (0, 1], got %r" % (ratio,))
        self.ratio = float(ratio)
        self._step_of: Dict[str, int] = {}

    def _indices(self, key, g_flat, k):
        raise NotImplementedError

    # the step counters ride the checkpoint: random-k's positions are a
    # function of (seed, key, step), and a resume that reset them would
    # draw the positions of the first steps again
    def state_dict(self) -> Dict:
        return {"residual": super().state_dict(),
                "step_of": {k: np.int64(v)
                            for k, v in sorted(self._step_of.items())}}

    def load_state_dict(self, state: Dict) -> None:
        if state is None:
            return
        state = dict(state)
        if "residual" in state or "step_of" in state:
            super().load_state_dict(state.get("residual") or {})
            self._step_of = {str(k): int(v)
                             for k, v in dict(state.get("step_of")
                                              or {}).items()}
        else:  # a flat residual dict
            super().load_state_dict(state)

    def reset_state(self) -> None:
        super().reset_state()
        self._step_of = {}

    def compress(self, key, grad) -> Dict:
        grad = _as_tensor(grad)
        g = self._carry_in(key, grad)
        shape, dtype = tuple(g.shape), g.dtype
        g_flat = g.reshape(-1).float()
        k = _k_of(shape, self.ratio)
        idx = self._indices(key, g_flat, k)
        if idx is None:  # data-dependent selection (top-k)
            idx = torch.topk(g_flat.abs(), k).indices.to(torch.int32)
        idx_l = idx.long()
        val = g_flat[idx_l]
        res = g_flat.clone()
        res[idx_l] = 0.0
        self._residual[key] = res.reshape(shape).to(dtype)
        self._step_of[key] = self._step_of.get(key, 0) + 1
        return {"kind": self.kind, "shape": shape,
                "dtype": dtype_name(dtype), "idx": idx, "val": val}

    def decompress(self, key, payload):
        return decompress_payload(payload)

    def payload_nbytes(self, shape, dtype) -> int:
        return _k_of(shape, self.ratio) * (4 + 4)  # int32 index + f32 value


class TopKCompressor(_SparseCompressor):
    """Keep the ``ratio`` fraction of largest-|g| elements per tensor."""

    kind = "topk"

    def _indices(self, key, g_flat, k):
        return None  # data-dependent: torch.topk in compress


class RandomKCompressor(_SparseCompressor):
    """Keep k elements at positions drawn per (key, step) from a
    ``torch.Generator`` seeded from ``seed``, the key's crc32 and the
    step: every process draws the same positions, and no index depends
    on the data."""

    kind = "randomk"

    def __init__(self, ratio=0.01, seed=0):
        super().__init__(ratio)
        self.seed = int(seed)

    def _indices(self, key, g_flat, k):
        step = self._step_of.get(key, 0)
        key_hash = zlib.crc32(str(key).encode()) & 0x7FFFFFFF
        gen = torch.Generator().manual_seed(
            (self.seed * 1000003 + key_hash) * 1000003 + step)
        n = g_flat.shape[0]
        idx = torch.randperm(n, generator=gen)[:min(k, n)]
        return idx.to(device=g_flat.device, dtype=torch.int32)


def symmetric_quantize(w, qmax=127.0):
    """``(int8 codes, amax f32)`` of ``w`` with the scale ``qmax / amax``
    (the reference's ``ops.quantization.symmetric_quantize``): an all-zero
    or non-finite tensor gets ``amax = 0`` and zero codes, and the scale's
    divisor is kept away from zero."""
    qmax_t = torch.tensor(qmax, dtype=torch.float32, device=w.device)
    amax = w.abs().max().float()
    ok = torch.isfinite(amax) & (amax > 0)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    amax = torch.where(ok, amax, zero)
    tiny = torch.tensor(2.0 ** -126, dtype=torch.float32, device=w.device)
    scale = torch.where(ok, qmax_t / torch.maximum(amax, tiny),
                        torch.ones((), dtype=torch.float32, device=w.device))
    q = torch.round(w.float() * scale)
    q = torch.where(torch.isfinite(q), q, zero)
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    return q, amax


def dequantize_tensor(q, amax, dtype=torch.float32):
    """Inverse of :func:`symmetric_quantize` at qmax 127: ``q * amax /
    127`` in f32, cast to ``dtype``."""
    return (q.float() * (amax / 127.0)).to(dtype)


class Int8Compressor(_ErrorFeedback):
    """Symmetric int8 pushes: amax-scaled codes, 4x smaller than f32;
    all-zero and non-finite tensors are contained by the quantizer."""

    kind = "int8"

    def compress(self, key, grad) -> Dict:
        grad = _as_tensor(grad)
        g = self._carry_in(key, grad)
        q, amax = symmetric_quantize(g.float())
        deq = dequantize_tensor(q, amax, dtype=torch.float32)
        self._residual[key] = (g.float() - deq).to(g.dtype)
        return {"kind": self.kind, "shape": tuple(g.shape),
                "dtype": dtype_name(g.dtype), "q": q, "amax": amax}

    def decompress(self, key, payload):
        return decompress_payload(payload)

    def payload_nbytes(self, shape, dtype) -> int:
        return int(np.prod(shape, dtype=np.int64)) + 4  # codes + amax


def decompress_payload(payload):
    """The dense gradient of a compressor's payload dict (a dense tensor,
    2-bit or uncompressed, passes through): the server side of the push
    wire format."""
    if not isinstance(payload, dict):
        return _as_tensor(payload)
    kind = payload["kind"]
    dtype = torch_dtype(str(payload["dtype"]))
    shape = tuple(payload["shape"])
    if kind in ("topk", "randomk"):
        val = _as_tensor(payload["val"])
        idx = _as_tensor(payload["idx"]).to(val.device).long()
        n = int(np.prod(shape, dtype=np.int64))
        dense = torch.zeros((n,), dtype=torch.float32, device=val.device)
        dense[idx] = val.float()
        return dense.reshape(shape).to(dtype)
    if kind == "int8":
        q = _as_tensor(payload["q"])
        amax = _as_tensor(payload["amax"]).to(q.device)
        return dequantize_tensor(q, amax).reshape(shape).to(dtype)
    raise ValueError("unknown push payload kind %r" % (kind,))


def make_compressor(spec, **kwargs) -> Optional[_ErrorFeedback]:
    """A compressor from a spec: ``None`` (off), an instance (returned
    as it is), one of ``"2bit" | "topk" | "randomk" | "int8"`` with the
    constructor's keywords (``ratio=``, ``threshold=``, ``seed=``), or a
    dict ``{"kind": "topk", "ratio": 0.05}`` (the CLI/JSON form)."""
    if spec is None or isinstance(spec, _ErrorFeedback):
        return spec
    if isinstance(spec, dict):
        spec = dict(spec)
        kind = spec.pop("kind")
        return make_compressor(kind, **{**spec, **kwargs})
    table = {"2bit": GradientCompression, "topk": TopKCompressor,
             "randomk": RandomKCompressor, "int8": Int8Compressor}
    if str(spec) not in table:
        raise ValueError("unknown compression %r (known: %s)"
                         % (spec, sorted(table)))
    return table[str(spec)](**kwargs)
