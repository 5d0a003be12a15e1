"""``mx.nd.random`` (port of ``incubator_mxnet_tpu/ndarray/random.py``:
``uniform``, ``normal``, ``randn``, ``randint`` and ``seed``).

Each draws from the generator of the device ``ctx`` names
(:mod:`..random`); ``ctx=None`` is the default CUDA card.
"""
from __future__ import annotations

from .. import random as _random
from ..ops import registry as _reg

__all__ = ["uniform", "normal", "randn", "randint", "seed"]


def _invoke0(name, out=None, **kw):
    return _reg.invoke(name, [], out=out, **kw)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kw):
    return _invoke0("_random_uniform", out=out, low=low, high=high,
                    shape=shape if shape is not None else (1,), dtype=dtype,
                    ctx=ctx)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kw):
    return _invoke0("_random_normal", out=out, loc=loc, scale=scale,
                    shape=shape if shape is not None else (1,), dtype=dtype,
                    ctx=ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kw):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None, **kw):
    return _invoke0("_random_randint", out=out, low=low, high=high,
                    shape=shape if shape is not None else (1,), dtype=dtype,
                    ctx=ctx)


def seed(seed_state, ctx="all"):
    _random.seed(seed_state, ctx)
