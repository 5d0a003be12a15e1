"""Seeded random numbers (port of ``incubator_mxnet_tpu/rng.py``,
``random.py`` and the ``_random_uniform``/``_random_normal``/
``_random_randint``/``bernoulli`` ops of ``ops/random_ops.py``).

MXNet keeps one generator per device, seeded by ``mx.random.seed``; so
does the port: one ``torch.Generator`` per ``torch.device``, made at
first use and seeded with the last :func:`seed` (0 until one is given).
The ops registered here draw from the generator of the device they run
on.  The numbers are not ``jax.random``'s at the same seed: tests compare
shapes, dtypes and moments.
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
