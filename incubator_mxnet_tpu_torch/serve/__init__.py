"""``mx.serve`` on the card: the bucketed engine, continuous batching, the
O(1) decode cache and the open-loop loadtest (port of
``incubator_mxnet_tpu/serve``).

- :class:`~.engine.ServeEngine`: one CUDA graph per bucketed batch shape
  and parameter slot, the parameters resident on the card and swapped
  under traffic by :meth:`~.engine.ServeEngine.update_params` (GL011
  drift gate, canary rollback, exactly-one-version attribution);
- :class:`~.batcher.ContinuousBatcher`: a bounded request queue with
  size- and deadline-triggered flushes, per-request errors, SLO
  deadlines with a reaper, a watched worker with bounded respawn,
  retry and circuit-breaker degradation to a fallback engine or to
  priority-aware shedding;
- :mod:`~.resilience`: :class:`~.resilience.RetryPolicy`,
  :class:`~.resilience.CircuitBreaker` and the request outcomes
  :class:`~.resilience.DeadlineExceeded`, :class:`~.resilience.Shed`
  and :class:`~.resilience.SwapRejected`;
- :class:`~.cache.CachedDecoder` / :func:`~.cache.init_cache`: the
  ring-slot K/V cache with an in-place update a token and the position
  on the card (one captured step a seq bucket), exercised by
  :class:`~.cache.TinyDecoderLM`;
- :func:`~.loadtest.poisson_loadtest`: open-loop Poisson traffic
  reporting p50/p95/p99, sustained QPS, batch occupancy and the captures
  after warmup (must be 0);
- :class:`~.flywheel.PromotionDaemon`: watches a checkpoint directory and
  walks each committed candidate through the promotion gauntlet
  (checksummed load, held-out metric through ``shadow_infer``, the
  canaried swap), every verdict in an append-only promotion ledger.

``ServeEngine(dtype="int8")`` is the weight-only int8 tier.
"""
from .batcher import (Backpressure, ContinuousBatcher, RequestError,
                      ServeStats)
from .cache import CachedDecoder, TinyDecoderLM, init_cache
from .engine import LintError, ServeEngine
from .flywheel import (PromotionDaemon, held_out_ce, load_candidate_params,
                       read_promotions)
from .loadtest import LoadReport, poisson_loadtest
from .resilience import (CircuitBreaker, DeadlineExceeded, RetryPolicy,
                         Shed, SwapRejected)

__all__ = ["Backpressure", "CachedDecoder", "CircuitBreaker",
           "ContinuousBatcher", "DeadlineExceeded", "LintError",
           "LoadReport", "PromotionDaemon", "RequestError", "RetryPolicy",
           "ServeEngine", "ServeStats", "Shed", "SwapRejected",
           "TinyDecoderLM", "held_out_ce", "init_cache",
           "load_candidate_params", "poisson_loadtest", "read_promotions"]
