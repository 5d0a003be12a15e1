"""Seeded random numbers (port of ``incubator_mxnet_tpu/rng.py``,
``random.py`` and the samplers of ``ops/random_ops.py``: uniform,
normal, randint, bernoulli, gamma, exponential, Poisson, the two negative
binomials, multinomial, the per-element uniform and normal, shuffle).

MXNet keeps one generator per device, seeded by ``mx.random.seed``; so
does the port: one ``torch.Generator`` per ``torch.device``, made at
first use and seeded with the last :func:`seed` (0 until one is given).
The ops registered here draw from the generator of the device they run
on.  The numbers are not ``jax.random``'s at the same seed: tests compare
shapes, dtypes and moments.  The negative binomials are gamma-Poisson
mixtures, as in the reference.
"""
from __future__ import annotations

import threading

import torch

from . import context
from .base import torch_dtype
from .ops.registry import register

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_GENERATORS = {}
_SEED = 0


def seed(seed_state, ctx="all"):
    """Seed the generator of every device (``ctx="all"``) or of one."""
    global _SEED
    s = int(seed_state) & 0x7FFFFFFF
    with _LOCK:
        if ctx == "all":
            _SEED = s
            _GENERATORS.clear()
        else:
            dev = context.resolve(ctx)
            _GENERATORS[dev] = torch.Generator(device=dev).manual_seed(s)


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device``)."""
    with _LOCK:
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(_SEED)
            _GENERATORS[device] = gen
        return gen


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dtype(dtype):
    return torch_dtype(dtype if dtype not in (None, "None") else "float32")


@register("_random_uniform", num_inputs=0, differentiable=False,
          aliases=("uniform", "random_uniform"))
def _uniform(low=0.0, high=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    u = torch.rand(_shape(shape), generator=generator(dev), device=dev,
                   dtype=_dtype(dtype))
    return u * (high - low) + low


@register("_random_normal", num_inputs=0, differentiable=False,
          aliases=("normal", "random_normal"))
def _normal(loc=0.0, scale=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    z = torch.randn(_shape(shape), generator=generator(dev), device=dev,
                    dtype=_dtype(dtype))
    return loc + scale * z


@register("_random_randint", num_inputs=0, differentiable=False,
          aliases=("random_randint", "randint"))
def _randint(low=0, high=1, shape=None, ctx=None, dtype="int32"):
    dev = context.resolve(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator(dev), device=dev,
                         dtype=torch_dtype(dtype or "int32"))


@register("bernoulli", num_inputs=0, differentiable=False)
def _bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None):
    """1 with probability ``prob``, else 0 (the reference's
    ``jax.random.bernoulli``), from the port's generator of ``ctx``."""
    dev = context.resolve(ctx)
    u = torch.rand(_shape(shape), generator=generator(dev), device=dev)
    return (u < prob).to(_dtype(dtype))


def _gamma_draw(alpha, shape, dev, dtype=torch.float32):
    """Standard gamma draws of ``shape`` with concentration ``alpha``."""
    conc = torch.full(_shape(shape), float(alpha), device=dev, dtype=dtype)
    return torch._standard_gamma(conc, generator=generator(dev))


def _poisson_draw(lam, dev):
    return torch.poisson(lam, generator=generator(dev))


@register("_random_gamma", num_inputs=0, differentiable=False,
          aliases=("random_gamma",))
def _gamma(alpha=1.0, beta=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    return _gamma_draw(alpha, shape, dev, _dtype(dtype)) * beta


@register("_random_exponential", num_inputs=0, differentiable=False,
          aliases=("random_exponential",))
def _exponential(lam=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    e = torch.empty(_shape(shape), device=dev, dtype=_dtype(dtype))
    return e.exponential_(1.0, generator=generator(dev)) / lam


@register("_random_poisson", num_inputs=0, differentiable=False,
          aliases=("random_poisson",))
def _poisson(lam=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    rate = torch.full(_shape(shape), float(lam), device=dev)
    return _poisson_draw(rate, dev).to(_dtype(dtype))


@register("_random_negative_binomial", num_inputs=0, differentiable=False,
          aliases=("random_negative_binomial",))
def _neg_binomial(k=1, p=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    lam = _gamma_draw(k, shape, dev) * ((1 - p) / p)
    return _poisson_draw(lam, dev).to(_dtype(dtype))


@register("_random_generalized_negative_binomial", num_inputs=0,
          differentiable=False,
          aliases=("random_generalized_negative_binomial",))
def _gen_neg_binomial(mu=1.0, alpha=1.0, shape=None, ctx=None, dtype=None):
    dev = context.resolve(ctx)
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = _gamma_draw(r, shape, dev) * ((1 - p) / p)
    return _poisson_draw(lam, dev).to(_dtype(dtype))


@register("_sample_multinomial", num_inputs=1, differentiable=False,
          aliases=("sample_multinomial", "multinomial"))
def _multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Draws from the categorical ``data`` (rows of probabilities, not
    necessarily normalized), each probability floored at 1e-38 as the
    reference's logits ``log(max(p, 1e-38))``; ``get_prob`` also returns
    the log-probability of each draw."""
    s = _shape(shape)
    n = 1
    for d in s:
        n *= int(d)
    n = max(n, 1)
    probs = torch.clamp_min(data, 1e-38)
    rows = probs.reshape(-1, data.shape[-1])
    out = torch.multinomial(rows.float(), n, replacement=True,
                            generator=generator(data.device))
    lead = () if data.ndim == 1 else (data.shape[0],)
    out = out.reshape(lead + s) if s else out[..., 0].reshape(lead)
    out = out.to(torch_dtype(dtype or "int32"))
    if get_prob:
        logp = torch.log(rows)
        prob = torch.gather(logp, 1, out.reshape(rows.shape[0], -1).long())
        return out, prob.reshape(out.shape)
    return out


@register("_sample_uniform", num_inputs=2, differentiable=False,
          aliases=("sample_uniform",))
def _sample_uniform(low, high, shape=None, dtype=None):
    """One draw of ``shape`` for each element of ``low``/``high``."""
    s = _shape(shape)
    u = torch.rand(tuple(low.shape) + s, generator=generator(low.device),
                   device=low.device, dtype=_dtype(dtype))
    lead = tuple(low.shape) + (1,) * len(s)
    return low.reshape(lead) + u * (high - low).reshape(lead)


@register("_sample_normal", num_inputs=2, differentiable=False,
          aliases=("sample_normal",))
def _sample_normal(mu, sigma, shape=None, dtype=None):
    s = _shape(shape)
    z = torch.randn(tuple(mu.shape) + s, generator=generator(mu.device),
                    device=mu.device, dtype=_dtype(dtype))
    return mu.reshape(tuple(mu.shape) + (1,) * len(s)) + z * sigma.reshape(
        tuple(sigma.shape) + (1,) * len(s))


@register("_shuffle", num_inputs=1, differentiable=False,
          aliases=("shuffle",))
def _shuffle_op(data):
    """``data`` with its rows (axis 0 only) permuted."""
    perm = torch.randperm(data.shape[0], generator=generator(data.device),
                          device=data.device)
    return data.index_select(0, perm)
