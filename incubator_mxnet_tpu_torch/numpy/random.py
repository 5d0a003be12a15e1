"""``mx.np.random`` (port of ``incubator_mxnet_tpu/numpy/random.py``):
NumPy's samplers drawing from the port's generator of the device they
run on (``ctx``: None is the card, or the enclosing ``device_scope``'s
device), seeded by ``mx.random.seed``.  The numbers are not
``jax.random``'s; the dtypes are the reference's (64-bit types on: the
distributions without a ``dtype`` argument give float64).
"""
from __future__ import annotations

import torch

from .. import context
from .. import random as _random
from ..base import torch_dtype
from ..ndarray import NDArray

__all__ = ["seed", "uniform", "normal", "randint", "rand", "randn", "choice",
           "shuffle", "multinomial", "gamma", "beta", "exponential",
           "lognormal", "laplace", "pareto", "power", "rayleigh", "weibull"]


def seed(s):
    _random.seed(s)


def _shape(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _gen(ctx):
    dev = context.resolve(ctx)
    return dev, _random.generator(dev)


def _u(size, ctx, dtype=torch.float64):
    dev, g = _gen(ctx)
    return torch.rand(_shape(size), generator=g, device=dev, dtype=dtype)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    u = _u(size, ctx, torch_dtype(dtype))
    return NDArray(low + u * (high - low))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    dev, g = _gen(ctx)
    z = torch.randn(_shape(size), generator=g, device=dev,
                    dtype=torch_dtype(dtype))
    return NDArray(loc + scale * z)


def randint(low, high=None, size=None, dtype=None, ctx=None):
    if high is None:
        low, high = 0, low
    dev, g = _gen(ctx)
    out = torch.randint(int(low), int(high), _shape(size), generator=g,
                        device=dev)
    return NDArray(out.to(torch_dtype(dtype or "int64")))


def rand(*size):
    return uniform(size=size or None)


def randn(*size):
    return normal(size=size or None)


def choice(a, size=None, replace=True, p=None, ctx=None):
    """Draws of ``range(a)`` (an int) or of ``a``'s rows, uniform or by
    ``p``."""
    from ..ops.npi import _choice

    p = p._data if isinstance(p, NDArray) else p
    if isinstance(a, (int, float)):
        return NDArray(_choice(int(a), size, replace, p, ctx))
    src = a._data if isinstance(a, NDArray) else torch.as_tensor(
        a, device=context.resolve(ctx))
    return NDArray(src[_choice(src.shape[0], size, replace, p, src.device)])


def shuffle(x):
    """Shuffle ``x``'s rows (axis 0) in place."""
    g = _random.generator(x._data.device)
    perm = torch.randperm(x.shape[0], generator=g, device=x._data.device)
    x._set_data(x._data.index_select(0, perm))


def multinomial(n, pvals, size=None):
    """Counts of ``n`` draws over the categories of ``pvals`` (int64)."""
    p = pvals._data if isinstance(pvals, NDArray) else torch.as_tensor(
        pvals, dtype=torch.float64, device=context.resolve(None))
    shape = _shape(size)
    rows = 1
    for d in shape:
        rows *= d
    g = _random.generator(p.device)
    draws = torch.multinomial(p.to(torch.float64).expand(rows, -1), int(n),
                              replacement=True, generator=g)
    k = p.shape[-1]
    counts = torch.zeros(rows, k, dtype=torch.int64, device=p.device)
    counts.scatter_add_(1, draws, torch.ones_like(draws))
    return NDArray(counts.reshape(shape + (k,)))


def gamma(shape, scale=1.0, size=None, ctx=None):
    dev, g = _gen(ctx)
    conc = torch.as_tensor(shape, dtype=torch.float64, device=dev)
    conc = conc.expand(_shape(size) or conc.shape).contiguous()
    return NDArray(torch._standard_gamma(conc, generator=g) * scale)


def beta(a, b, size=None, ctx=None):
    dev, g = _gen(ctx)
    s = _shape(size)
    x = torch._standard_gamma(torch.full(s, float(a), dtype=torch.float64,
                                         device=dev), generator=g)
    y = torch._standard_gamma(torch.full(s, float(b), dtype=torch.float64,
                                         device=dev), generator=g)
    return NDArray(x / (x + y))


def exponential(scale=1.0, size=None, ctx=None):
    return NDArray(-torch.log1p(-_u(size, ctx)) * scale)


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None):
    dev, g = _gen(ctx)
    z = torch.randn(_shape(size), generator=g, device=dev,
                    dtype=torch.float64)
    return NDArray(torch.exp(mean + sigma * z))


def laplace(loc=0.0, scale=1.0, size=None, ctx=None):
    u = _u(size, ctx) - 0.5
    return NDArray(loc - scale * torch.sign(u) * torch.log1p(
        -2 * torch.abs(u)))


def pareto(a, size=None, ctx=None):
    """NumPy's Pareto II (Lomax): the classical Pareto less 1."""
    return NDArray(torch.pow(1 - _u(size, ctx), -1.0 / a) - 1.0)


def power(a, size=None, ctx=None):
    return NDArray(_u(size, ctx) ** (1.0 / a))


def rayleigh(scale=1.0, size=None, ctx=None):
    u = _u(size, ctx)
    return NDArray(scale * torch.sqrt(-2.0 * torch.log1p(-u)))


def weibull(a, size=None, ctx=None):
    u = _u(size, ctx)
    return NDArray((-torch.log1p(-u)) ** (1.0 / a))
