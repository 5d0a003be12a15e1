"""``mx.nd.random`` (port of ``incubator_mxnet_tpu/ndarray/random.py``:
``uniform``, ``normal``, ``randn``, ``gamma``, ``exponential``,
``poisson``, the two negative binomials, ``randint``, ``multinomial``,
``shuffle``, ``bernoulli`` and ``seed``).

Each draws from the generator of the device ``ctx`` names
(:mod:`..random`); ``ctx=None`` is the default CUDA card.
"""
from __future__ import annotations

from .. import random as _random
from ..ops import registry as _reg

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "bernoulli", "seed"]


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


def _shape(shape):
    return shape if shape is not None else (1,)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None,
          **kw):
    return _invoke0("_random_gamma", out=out, alpha=alpha, beta=beta,
                    shape=_shape(shape), dtype=dtype, ctx=ctx)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None, **kw):
    return _invoke0("_random_exponential", out=out, lam=1.0 / scale,
                    shape=_shape(shape), dtype=dtype, ctx=ctx)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **kw):
    return _invoke0("_random_poisson", out=out, lam=lam, shape=_shape(shape),
                    dtype=dtype, ctx=ctx)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                      out=None, **kw):
    return _invoke0("_random_negative_binomial", out=out, k=k, p=p,
                    shape=_shape(shape), dtype=dtype, ctx=ctx)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None, **kw):
    return _invoke0("_random_generalized_negative_binomial", out=out, mu=mu,
                    alpha=alpha, shape=_shape(shape), dtype=dtype, ctx=ctx)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _reg.invoke("_sample_multinomial", [data], shape=shape,
                       get_prob=get_prob, dtype=dtype)


def shuffle(data, **kw):
    return _reg.invoke("_shuffle", [data])


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None,
              **kw):
    return _invoke0("bernoulli", out=out, prob=prob, shape=_shape(shape),
                    dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None, **kw):
    return _invoke0("_random_randint", out=out, low=low, high=high,
                    shape=shape if shape is not None else (1,), dtype=dtype,
                    ctx=ctx)


def seed(seed_state, ctx="all"):
    _random.seed(seed_state, ctx)
