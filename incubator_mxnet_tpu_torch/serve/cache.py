"""Device-carried decode cache with an O(1) in-place update a token (port
of ``incubator_mxnet_tpu/serve/cache.py``).

Autoregressive decode is the hard case for a shape-bucketed server: the
context grows every token, so recomputing the prefix is O(T^2) work per
sequence and a new program shape per length.  The cache keeps it to one
fixed-shape program:

- the K/V context lives on the card in ring-slot layout, per layer one
  ``(batch, max_len, heads, head_dim)`` buffer; a token's K/V row is
  written in place at slot ``pos % max_len`` (``index_copy_``), where the
  reference donates the cache and XLA updates it in place;
- the position ``pos`` is a device tensor (int64, 0-d), read and advanced
  on the card, never on the host: a decode step is one program whatever
  the position, so on the card it is one captured CUDA graph per (batch,
  seq bucket), replayed for every token;
- ``max_len`` is bucketed like the engine's batch (``seq_buckets``).

Beyond ``max_len`` the ring overwrites the oldest slot and attention
becomes a sliding window of the last ``max_len`` tokens (positions
saturate at the end of the LM's table).  ``TinyDecoderLM.apply_tokens``
with ``window=max_len`` recomputes exactly that, so cached decode can be
held against full recompute through a wraparound too.

:class:`TinyDecoderLM` is the small functional decoder LM that exercises
the cache (pre-LN transformer, learned positions, GELU MLP, an explicit
head).  Its attention is plain ``einsum``/softmax, as the reference's
is: no kernel of the port's is on this path.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from .. import context
from ..parallel.aot import capture_timed

__all__ = ["CachedDecoder", "TinyDecoderLM", "init_cache"]


def init_cache(n_layers: int, batch: int, max_len: int, n_heads: int,
               head_dim: int, dtype=torch.float32, device=None
               ) -> Dict[str, Any]:
    """Fresh decode cache: per-layer K/V ring buffers and the carried
    position, on ``device`` (``None``: the card)."""
    device = context.resolve(device)
    shape = (batch, max_len, n_heads, head_dim)
    return {"k": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(n_layers)],
            "pos": torch.zeros((), dtype=torch.int64, device=device)}


def _ring_write(buf, row, pos):
    """O(1) in-place ring write: ``row`` (batch, heads, head_dim) lands at
    slot ``pos % max_len`` of ``buf`` (batch, max_len, heads, head_dim)."""
    slot = torch.remainder(pos, buf.shape[1]).reshape(1)
    buf.index_copy_(1, slot, row[:, None])


class TinyDecoderLM:
    """Minimal pre-LN causal transformer decoder, functional: parameters
    are a nested dict of tensors (``init``), the reference's tree.

    Multi-head causal attention, learned positions, a GELU (tanh) MLP and
    an explicit head (no weight tying, so a logits comparison sees every
    parameter)."""

    def __init__(self, vocab: int = 64, d_model: int = 32, n_heads: int = 2,
                 n_layers: int = 2, d_ff: int = 64, max_len: int = 64):
        if d_model % n_heads:
            raise ValueError("d_model %d not divisible by n_heads %d"
                             % (d_model, n_heads))
        self.vocab = vocab
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.max_len = max_len
        self.head_dim = d_model // n_heads

    # -- params --------------------------------------------------------
    def param_shapes(self) -> Dict[str, Any]:
        """The parameter tree's shapes (what ``init`` makes)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        block = {"ln1": (d,), "wq": (d, d), "wk": (d, d), "wv": (d, d),
                 "wo": (d, d), "ln2": (d,), "w1": (d, f), "b1": (f,),
                 "w2": (f, d), "b2": (d,)}
        return {"embed": (v, d), "pos": (self.max_len, d),
                "blocks": [dict(block) for _ in range(self.n_layers)],
                "ln_f": (d,), "head": (d, v)}

    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Parameters from ``seed`` on ``device`` (``None``: the card):
        normal matrices scaled by 1/sqrt(fan-in) (0.02 for the embedding
        and position tables), LN scales 1, biases 0."""
        device = context.resolve(device)
        gen = torch.Generator().manual_seed(int(seed))

        def mat(shape, scale=None):
            scale = scale or 1.0 / math.sqrt(shape[0])
            return (torch.randn(shape, generator=gen) * scale).to(device)

        d, f = self.d_model, self.d_ff
        blocks = []
        for _ in range(self.n_layers):
            blocks.append({
                "ln1": torch.ones(d, device=device),
                "wq": mat((d, d)), "wk": mat((d, d)), "wv": mat((d, d)),
                "wo": mat((d, d)),
                "ln2": torch.ones(d, device=device),
                "w1": mat((d, f)), "b1": torch.zeros(f, device=device),
                "w2": mat((f, d)), "b2": torch.zeros(d, device=device)})
        return {"embed": mat((self.vocab, d), scale=0.02),
                "pos": mat((self.max_len, d), scale=0.02),
                "blocks": blocks,
                "ln_f": torch.ones(d, device=device),
                "head": mat((d, self.vocab))}

    # -- shared pieces -------------------------------------------------
    @staticmethod
    def _ln(x, scale):
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * scale

    def _heads(self, x, w):
        # (..., d) @ (d, d) -> (..., heads, head_dim)
        y = x @ w
        return y.reshape(y.shape[:-1] + (self.n_heads, self.head_dim))

    @staticmethod
    def _mlp(blk, x):
        return F.gelu(x @ blk["w1"] + blk["b1"], approximate="tanh") \
            @ blk["w2"] + blk["b2"]

    # -- full recompute (the parity reference + the prefill path) ------
    def apply_tokens(self, params, tokens, return_kv: bool = False,
                     window=None):
        """Full-context causal forward: ``tokens`` (B, T) -> logits
        (B, T, V).  ``return_kv=True`` also returns the per-layer K/V
        ``(B, T, H, Dh)``.  ``window``: each query sees at most the last
        ``window`` keys, itself included (the ring's sliding window), and
        positions past the table saturate at its end."""
        tokens = tokens.long()
        B, T = tokens.shape
        dev = tokens.device
        pos = torch.clamp(torch.arange(T, device=dev),
                          max=params["pos"].shape[0] - 1)
        x = params["embed"][tokens] + params["pos"][pos][None]
        scale = 1.0 / math.sqrt(self.head_dim)
        qi = torch.arange(T, device=dev)[:, None]
        ki = torch.arange(T, device=dev)[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (qi - ki < int(window))
        kvs = []
        for blk in params["blocks"]:
            h = self._ln(x, blk["ln1"])
            q = self._heads(h, blk["wq"])          # (B, T, H, Dh)
            k = self._heads(h, blk["wk"])
            v = self._heads(h, blk["wv"])
            kvs.append((k, v))
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            att = att.masked_fill(~mask[None, None], float("-inf"))
            att = torch.softmax(att, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", att, v)
            x = x + o.reshape(B, T, self.d_model) @ blk["wo"]
            x = x + self._mlp(blk, self._ln(x, blk["ln2"]))
        logits = self._ln(x, params["ln_f"]) @ params["head"]
        return (logits, kvs) if return_kv else logits

    # -- O(1) cached step ----------------------------------------------
    def apply_step(self, params, token, cache):
        """One decode step: ``token`` (B,) -> logits (B, V).  Writes one
        ring slot per layer and advances ``cache["pos"]``, in place; the
        position is read on the card only, so the step captures as one
        graph."""
        pos = cache["pos"]
        S = cache["k"][0].shape[1]
        B = token.shape[0]
        # learned position, clamped into the table (past max_len the
        # ring serves a sliding window; positions saturate)
        p_idx = torch.clamp(pos, max=params["pos"].shape[0] - 1).reshape(1)
        x = params["embed"][token.long()] \
            + params["pos"].index_select(0, p_idx)
        scale = 1.0 / math.sqrt(self.head_dim)
        # slots ever written: ring-full means everything is context
        valid = torch.arange(S, device=pos.device) < \
            torch.clamp(pos + 1, max=S)
        for li, blk in enumerate(params["blocks"]):
            h = self._ln(x, blk["ln1"])
            q = self._heads(h, blk["wq"])          # (B, H, Dh)
            k1 = self._heads(h, blk["wk"])
            v1 = self._heads(h, blk["wv"])
            kbuf, vbuf = cache["k"][li], cache["v"][li]
            _ring_write(kbuf, k1, pos)
            _ring_write(vbuf, v1, pos)
            att = torch.einsum("bhd,bshd->bhs", q, kbuf) * scale
            att = att.masked_fill(~valid[None, None], float("-inf"))
            att = torch.softmax(att, dim=-1)
            o = torch.einsum("bhs,bshd->bhd", att, vbuf)
            x = x + o.reshape(B, self.d_model) @ blk["wo"]
            x = x + self._mlp(blk, self._ln(x, blk["ln2"]))
        logits = self._ln(x, params["ln_f"]) @ params["head"]
        pos.add_(1)
        return logits

    def prefill_into_cache(self, params, tokens, cache):
        """Full-recompute forward over the prompt whose per-layer K/V
        seed the cache: returns logits (B, T, V) and advances the cache
        position past the prompt, in place."""
        T = tokens.shape[1]
        S = cache["k"][0].shape[1]
        if T > S:
            raise ValueError("prompt length %d exceeds cache max_len %d"
                             % (T, S))
        logits, kvs = self.apply_tokens(params, tokens, return_kv=True)
        for li, (k, v) in enumerate(kvs):
            cache["k"][li][:, :T].copy_(k)
            cache["v"][li][:, :T].copy_(v)
        cache["pos"].add_(T)
        return logits


class _StepGraph:
    """The decode step of one (batch, seq bucket) captured on the card:
    a static token buffer in, static logits out, the cache written in
    place."""

    def __init__(self, dec, cache, token):
        self.token = token.clone()
        lm, params = dec.lm, dec.params
        self.graph, self.logits, _ = capture_timed(
            lm.apply_step, params, self.token, cache)

    def run(self, token):
        self.token.copy_(token)
        self.graph.replay()
        return self.logits.clone()


class CachedDecoder:
    """Decode loop over a :class:`TinyDecoderLM` (or any object with the
    same ``apply_step``/``prefill_into_cache`` surface) that owns the
    program table and the cache.

    Programs: one prefill per (batch, prompt length, seq bucket), run
    eagerly (it runs once a sequence), and ONE step per (batch, seq
    bucket): on the card the first step of a key runs eagerly (kernels
    and library handles warmed) and is then captured as a CUDA graph that
    every later token replays.  ``compiles`` counts the programs built.
    The cache of a (batch, seq bucket) is allocated once and cleared by
    each :meth:`start`, so the captured step keeps its addresses.
    ``device``: where it decodes (``None``: the card)."""

    def __init__(self, lm, params, seq_buckets: Sequence[int] = (64,),
                 device=None):
        self.lm = lm
        self.seq_buckets = tuple(sorted(int(b) for b in seq_buckets))
        if not self.seq_buckets or any(b < 1 for b in self.seq_buckets):
            raise ValueError("seq_buckets must be positive lengths, got %r"
                             % (seq_buckets,))
        if self.seq_buckets[-1] > lm.max_len:
            raise ValueError(
                "seq bucket %d exceeds the LM's position table (%d)"
                % (self.seq_buckets[-1], lm.max_len))
        self.device = context.resolve(device)
        self.params = _tree_to(params, self.device)
        self._built = set()                      # program keys
        self._graphs: Dict[tuple, _StepGraph] = {}   # captured steps
        self._caches: Dict[tuple, Dict[str, Any]] = {}
        self.compiles = 0
        self.cache = None
        self.max_len = None

    def seq_bucket_for(self, total_len: int) -> int:
        for b in self.seq_buckets:
            if total_len <= b:
                return b
        raise ValueError("sequence of %d tokens exceeds the largest seq "
                         "bucket %d" % (total_len, self.seq_buckets[-1]))

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, dtype=torch.int64).to(self.device)

    # ------------------------------------------------------------------
    def start(self, tokens, max_new: int):
        """Begin decoding: pick the seq bucket for ``prompt + max_new``,
        clear the bucket's cache, run the prefill.  ``tokens`` is the
        prompt (B, T0).  Returns the prompt logits (B, T0, V)."""
        tokens = self._tokens(tokens)
        B, T0 = tokens.shape
        self.max_len = self.seq_bucket_for(T0 + int(max_new))
        lm = self.lm
        cache = self._caches.get((B, self.max_len))
        if cache is None:
            cache = init_cache(lm.n_layers, B, self.max_len, lm.n_heads,
                               lm.head_dim, device=self.device)
            self._caches[(B, self.max_len)] = cache
        else:
            for buf in cache["k"] + cache["v"] + [cache["pos"]]:
                buf.zero_()
        self.cache = cache
        key = ("prefill", B, T0, self.max_len)
        if key not in self._built:
            self._built.add(key)
            self.compiles += 1
        with torch.no_grad():
            return lm.prefill_into_cache(self.params, tokens, cache)

    def step(self, token):
        """Decode one token for every sequence: ``token`` (B,) -> logits
        (B, V).  Every call after a key's first replays the same program
        (the position is device state; the cache is written in
        place)."""
        if self.cache is None:
            raise RuntimeError("start() a sequence before step()")
        token = self._tokens(token)
        key = ("step", token.shape[0], self.max_len)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.run(token)
        with torch.no_grad():
            logits = self.lm.apply_step(self.params, token, self.cache)
            if key not in self._built:
                self._built.add(key)
                self.compiles += 1
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        self._graphs[key] = _StepGraph(self, self.cache,
                                                       token)
        return logits

    @property
    def pos(self) -> int:
        return 0 if self.cache is None else int(self.cache["pos"])


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)
