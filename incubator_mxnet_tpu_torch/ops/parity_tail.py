"""The last user-visible ops of the registry (port of
``incubator_mxnet_tpu/ops/parity_tail.py``): the elementwise comparison
and scatter aliases, scalar logic ops, ``moments``, ``reshape_like``,
``softmax_cross_entropy``, ``_histogram``, the index ops, ``im2col`` and
``col2im``, the straight-through estimators, the contrib helpers, the
``*_like`` samplers, the multi-tensor and mixed-precision optimizer
updates, ``IdentityAttachKLSparseReg`` and ``_contrib_hawkesll``.

The reference computes all of these with XLA, none with Pallas, so they
are torch ops on the inputs' device.  Its ``jax.custom_vjp``s are
``torch.autograd.Function``s here.  The samplers draw from the port's
generator of the device they run on (``random.generator``): their
numbers are not ``jax.random``'s, their moments are.  The reference runs
with 64-bit types on, so ``getnnz`` and the index ops return int64.

Like the reference, ``reset_arrays`` and the updates return new tensors
(``mutate_idx`` names the inputs that a caller commits them to), and
``multi_sum_sq`` returns one float32 scalar an array.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import context
from ..base import torch_dtype
from ..random import generator
from .optimizer_ops import _apply_wd
from .registry import alias, register

__all__ = []

# -- aliases -----------------------------------------------------------------

for _n, _b in (("equal", "broadcast_equal"),
               ("not_equal", "broadcast_not_equal"),
               ("greater", "broadcast_greater"),
               ("greater_equal", "broadcast_greater_equal"),
               ("less", "broadcast_lesser"),
               ("less_equal", "broadcast_lesser_equal")):
    alias(_n, _b)
alias("BatchNorm_v1", "BatchNorm")
alias("_scatter_plus_scalar", "_plus_scalar")
alias("_scatter_minus_scalar", "_minus_scalar")
alias("_grad_add", "elemwise_add")
alias("_hypot", "broadcast_hypot")
alias("_split_v2", "split_v2")  # its output count: symbol._compose_num_outputs


def _logic_scalar(name, fn):
    @register(name, num_inputs=1)
    def _op(data, scalar=0.0):
        return fn(data != 0, torch.tensor(float(scalar) != 0,
                                          device=data.device)).to(data.dtype)
    return _op


_logic_scalar("_logical_and_scalar", torch.logical_and)
_logic_scalar("_logical_or_scalar", torch.logical_or)
_logic_scalar("_logical_xor_scalar", torch.logical_xor)


@register("_hypot_scalar", num_inputs=1)
def _hypot_scalar(data, scalar=0.0):
    return torch.hypot(data, torch.tensor(float(scalar), dtype=data.dtype,
                                          device=data.device))


# -- tensor utilities ----------------------------------------------------------

def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


@register("moments", num_inputs=1, num_outputs=2)
def _moments(data, axes=None, keepdims=False):
    """Mean and variance in one op, the variance in the two-pass form."""
    dims = _axes(axes) or tuple(range(data.dim()))
    mean = data.mean(dim=dims, keepdim=True)
    var = torch.square(data - mean).mean(dim=dims, keepdim=bool(keepdims))
    if not keepdims:
        mean = mean.reshape(var.shape)
    return mean, var


@register("reshape_like", num_inputs=2)
def _reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                  rhs_end=None):
    """``lhs`` reshaped to ``rhs``'s shape, or only its axes [lhs_begin,
    lhs_end) to ``rhs``'s [rhs_begin, rhs_end)."""
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    lb = int(lhs_begin or 0)
    le = lhs.dim() if lhs_end is None else int(lhs_end)
    rb = int(rhs_begin or 0)
    re = rhs.dim() if rhs_end is None else int(rhs_end)
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re])
                       + tuple(lhs.shape[le:]))


@register("softmax_cross_entropy", num_inputs=2)
def _softmax_cross_entropy(data, label):
    """The cross entropy summed over the batch."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long()[:, None]).sum()


def _linspace_edges(lo, hi, bins, dtype):
    """``jnp.linspace(lo, hi, bins + 1)``: ``lo * (1 - s) + hi * s`` with
    ``s = i / bins``, the last edge ``hi`` itself.  ``bins`` divides as a
    tensor: a division by a Python number on the card is a product by its
    reciprocal, and the edges decide the bins."""
    s = torch.arange(bins, dtype=dtype, device=lo.device) / torch.tensor(
        bins, dtype=dtype, device=lo.device)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


@register("_histogram", num_inputs=1, differentiable=False, num_outputs=2,
          aliases=("histogram",))
def _histogram(data, bin_cnt=10, range=None):  # noqa: A002 - parity name
    """(counts, edges) of ``jnp.histogram``: ``bin_cnt`` bins over
    ``range`` (the data's extent when None, widened by 0.5 each way when
    it is empty); the last bin holds its right edge; counts in the
    data's floating type."""
    x = data if data.is_floating_point() else data.to(
        torch.float64 if data.dtype == torch.int64 else torch.float32)
    bins = int(bin_cnt)
    if range is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.tensor(float(range[0]), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(range[1]), dtype=x.dtype, device=x.device)
    empty = lo == hi
    lo, hi = torch.where(empty, lo - 0.5, lo), torch.where(empty, hi + 0.5,
                                                           hi)
    edges = _linspace_edges(lo, hi, bins, x.dtype)
    flat = x.reshape(-1)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bins, idx)
    # slot 0 is below the range, slot bins + 1 above it: both dropped
    counts = torch.zeros(bins + 2, dtype=x.dtype, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(flat))
    return counts[1:bins + 1], edges


@register("_ravel_multi_index", num_inputs=1, differentiable=False)
def _ravel_multi_index(data, shape=None):
    """The flat indices of the columns of ``data`` (one row an axis) in
    ``shape``, each index clipped into its axis."""
    shape = tuple(int(s) for s in shape)
    idx = data.long()
    out = torch.zeros(idx.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(shape):
        out = out * s + idx[i].clamp(0, s - 1)
    return out


@register("_unravel_index", num_inputs=1, differentiable=False)
def _unravel_index(data, shape=None):
    """The inverse: one row an axis of ``shape``.  Out-of-range flat
    indices clip as ``jnp.unravel_index``'s do."""
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape))
    flat = data.long().clamp(-size, size - 1)
    flat = torch.where(flat < 0, flat + size, flat)
    rows = []
    for s in reversed(shape):
        rows.append(flat % s)
        flat = flat // s
    return torch.stack(rows[::-1]).to(
        torch.int64 if data.is_floating_point() else data.dtype)


def _slice_key(begin, end, step):
    return tuple(slice(None if b is None else int(b),
                       None if e is None else int(e),
                       int(s) if s else None)
                 for b, e, s in zip(begin, end,
                                    step or (None,) * len(begin)))


def _slice_set(data, begin, end, step, value):
    """``data`` with the slice [begin:end:step] set to ``value``, as a new
    tensor (the reference's ``.at[].set``).  Axes with a negative step
    are indexed by their positions, which torch slicing cannot take."""
    key = _slice_key(begin, end, step)
    out = data.clone()
    if any(k.step is not None and k.step < 0 for k in key):
        nd = len(key)
        key = tuple(torch.arange(*k.indices(data.shape[d]),
                                 device=data.device).reshape(
                                     [-1 if e == d else 1 for e in range(nd)])
                    for d, k in enumerate(key))
    out[key] = value
    return out


@register("_slice_assign", num_inputs=2)
def _slice_assign(data, value, begin=(), end=(), step=()):
    """``data`` with the slice [begin:end:step] set to ``value``: a new
    array, as the reference's ``.at[].set``."""
    return _slice_set(data, begin, end, step, value.to(data.dtype))


@register("_slice_assign_scalar", num_inputs=1)
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    return _slice_set(data, begin, end, step, float(scalar))


@register("_identity_with_attr_like_rhs", num_inputs=2)
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("_zeros_without_dtype", num_inputs=0, differentiable=False)
def _zeros_without_dtype(shape=(), ctx=None, dtype=None):
    return torch.zeros(tuple(shape), device=context.resolve(ctx),
                       dtype=torch.float32 if dtype in (None, -1)
                       else torch_dtype(dtype))


def _reduce_bool(fn, data, axis, keepdims):
    dims = _axes(axis)
    b = data != 0
    if dims is None:
        dims = tuple(range(data.dim()))
    if not dims:
        return b
    return fn(b, dim=dims, keepdim=bool(keepdims))


@register("_np_all", num_inputs=1, differentiable=False, aliases=("all",))
def _np_all(data, axis=None, keepdims=False):
    return _reduce_bool(torch.all, data, axis, keepdims)


@register("_np_any", num_inputs=1, differentiable=False, aliases=("any",))
def _np_any(data, axis=None, keepdims=False):
    return _reduce_bool(torch.any, data, axis, keepdims)


# -- im2col / col2im -------------------------------------------------------------

def _conv_geometry(spatial, kernel, stride, dilate, pad):
    nsp = len(spatial)
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in stride) if stride else (1,) * nsp
    dilate = tuple(int(d) for d in dilate) if dilate else (1,) * nsp
    pad = tuple(int(p) for p in pad) if pad else (0,) * nsp
    out = tuple((s + 2 * p - d * (k - 1) - 1) // st + 1
                for s, k, st, d, p in zip(spatial, kernel, stride, dilate,
                                          pad))
    return kernel, stride, dilate, pad, out


def _taps(kernel, dilate, stride, out):
    """Per kernel tap (channel-major order within a channel: the last
    spatial axis fastest), the slice of the padded input it reads."""
    for tap in np.ndindex(*kernel):
        yield tuple(slice(t * d, t * d + (o - 1) * st + 1, st)
                    for t, d, st, o in zip(tap, dilate, stride, out))


@register("im2col", num_inputs=1)
def _im2col(data, kernel=None, stride=None, dilate=None, pad=None):
    """(N, C, *spatial) -> (N, C * prod(kernel), L): a column per output
    position, its rows channel-major (channel, then the kernel taps with
    the last axis fastest), as ``lax.conv_general_dilated_patches``."""
    n, c = data.shape[:2]
    kernel, stride, dilate, pad, out = _conv_geometry(
        data.shape[2:], kernel, stride, dilate, pad)
    x = torch.nn.functional.pad(
        data, tuple(p for q in reversed(pad) for p in (q, q)))
    cols = torch.stack([x[(slice(None), slice(None)) + sl]
                        for sl in _taps(kernel, dilate, stride, out)], dim=2)
    return cols.reshape(n, c * int(np.prod(kernel)), -1)


@register("col2im", num_inputs=1)
def _col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
            pad=None):
    """The adjoint of ``im2col``: each column's rows added back at the
    positions they were read from."""
    size = tuple(int(s) for s in output_size)
    kernel, stride, dilate, pad, out = _conv_geometry(
        size, kernel, stride, dilate, pad)
    n = data.shape[0]
    k = int(np.prod(kernel))
    c = data.shape[1] // k
    cols = data.reshape((n, c, k) + out)
    x = torch.zeros((n, c) + tuple(s + 2 * p for s, p in zip(size, pad)),
                    dtype=data.dtype, device=data.device)
    for t, sl in enumerate(_taps(kernel, dilate, stride, out)):
        x[(slice(None), slice(None)) + sl] += cols[:, :, t]
    return x[(slice(None), slice(None)) + tuple(
        slice(p, p + s) for p, s in zip(pad, size))]


# -- straight-through estimators ------------------------------------------------

class _StraightThrough(torch.autograd.Function):
    """``fn(x)`` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@register("_contrib_round_ste", num_inputs=1)
def _round_ste(data):
    return _StraightThrough.apply(data, torch.round)


@register("_contrib_sign_ste", num_inputs=1)
def _sign_ste(data):
    return _StraightThrough.apply(data, torch.sign)


class _GradMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * torch.tensor(ctx.scalar, dtype=g.dtype,
                                device=g.device), None


@register("_contrib_gradientmultiplier", num_inputs=1)
def _gradientmultiplier(data, scalar=1.0):
    """The identity forward; backward scales the gradient by ``scalar``."""
    return _GradMultiplier.apply(data, float(scalar))


# -- contrib helpers ---------------------------------------------------------

@register("_contrib_quadratic", num_inputs=1, aliases=("_npx_quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a * x^2 + b * x + c`` (the tutorial custom op)."""
    return float(a) * torch.square(data) + float(b) * data + float(c)


@register("_contrib_allclose", num_inputs=2, differentiable=False)
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 where every element of ``a`` is within ``atol + rtol * |b|`` of
    ``b``'s, else 0.0 (float32)."""
    return torch.isclose(a, b, rtol=float(rtol), atol=float(atol),
                         equal_nan=bool(equal_nan)).all().to(torch.float32)


@register("_contrib_arange_like", num_inputs=1, differentiable=False)
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i`` (each value ``repeat`` times) over the data's
    elements, or along ``axis``; computed in float32."""
    def ramp(n):
        k = max(int(repeat), 1)
        base = torch.arange((n + k - 1) // k, dtype=torch.float32,
                            device=data.device)
        vals = float(start) + float(step) * base
        return torch.repeat_interleave(vals, k)[:n].to(data.dtype)

    if axis is None:
        return ramp(data.numel()).reshape(data.shape)
    return ramp(data.shape[int(axis)])


@register("_contrib_getnnz", num_inputs=1, differentiable=False)
def _getnnz(data, axis=None):
    nz = data != 0
    if axis is None:
        return nz.sum().to(torch.int64)
    return nz.sum(dim=int(axis)).to(torch.int64)


def _corner_parts(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (boxes[..., 0] + boxes[..., 2]) / 2, \
        (boxes[..., 1] + boxes[..., 3]) / 2, w, h


@register("_contrib_box_encode", num_inputs=4, differentiable=False,
          num_outputs=2)
def _box_encode(samples, matches, anchors, refs, means=None, stds=None):
    """SSD training targets: corner anchors and their matched corner
    references as (center offsets / size, log size ratios), normalised
    by ``means`` and ``stds``; 0 where a sample is not positive."""
    dev = anchors.device
    means = torch.tensor(means if means is not None else (0., 0., 0., 0.),
                         dtype=torch.float64, device=dev)
    stds = torch.tensor(stds if stds is not None else (.1, .1, .2, .2),
                        dtype=torch.float64, device=dev)
    idx = matches.long()[..., None].expand(-1, -1, refs.shape[-1])
    ref = torch.gather(refs, 1, idx)
    ax, ay, aw, ah = _corner_parts(anchors)
    rx, ry, rw, rh = _corner_parts(ref)
    t = torch.stack([(rx - ax) / aw, (ry - ay) / ah,
                     torch.log(torch.clamp_min(rw / aw, 1e-12)),
                     torch.log(torch.clamp_min(rh / ah, 1e-12))], dim=-1)
    t = (t - means) / stds
    valid = (samples > 0.5)[..., None]
    return torch.where(valid, t, torch.zeros((), dtype=t.dtype, device=dev)), \
        torch.broadcast_to(valid, t.shape).to(t.dtype)


@register("_contrib_box_decode", num_inputs=2, differentiable=False)
def _box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
                clip=-1.0, format="corner"):  # noqa: A002 - parity name
    """Box deltas against anchors (``corner`` or ``center`` format) to
    corner boxes, clipped to [0, clip] when ``clip`` > 0."""
    if format == "corner":
        ax, ay, aw, ah = _corner_parts(anchors)
    else:
        ax, ay, aw, ah = (anchors[..., i] for i in range(4))
    dx = data[..., 0] * float(std0) * aw + ax
    dy = data[..., 1] * float(std1) * ah + ay
    dw = torch.exp(data[..., 2] * float(std2)) * aw / 2
    dh = torch.exp(data[..., 3] * float(std3)) * ah / 2
    out = torch.stack([dx - dw, dy - dh, dx + dw, dy + dh], dim=-1)
    if clip > 0:
        out = torch.clamp(out, 0, float(clip))
    return out


# -- *_like samplers -----------------------------------------------------------

def _like_sampler(name, draw):
    @register(name, num_inputs=1, differentiable=False)
    def _fn(data, **attrs):
        dev = data.device
        return draw(generator(dev), tuple(data.shape), dev,
                    attrs).to(data.dtype)
    return _fn


def _gamma(gen, shape, dev, alpha):
    conc = torch.full(shape, float(alpha), device=dev)
    return torch._standard_gamma(conc, generator=gen)


def _neg_binomial(gen, shape, dev, k, p):
    """NB(k, p) as Poisson(Gamma(k, (1 - p) / p))."""
    lam = _gamma(gen, shape, dev, k) * ((1.0 - p) / p)
    return torch.poisson(lam, generator=gen)


_like_sampler("_random_uniform_like", lambda g, s, d, a: torch.rand(
    s, generator=g, device=d) * (float(a.get("high", 1.0))
                                 - float(a.get("low", 0.0)))
    + float(a.get("low", 0.0)))
_like_sampler("_random_normal_like", lambda g, s, d, a: float(
    a.get("loc", 0.0)) + float(a.get("scale", 1.0)) * torch.randn(
        s, generator=g, device=d))
_like_sampler("_random_exponential_like", lambda g, s, d, a: torch.empty(
    s, device=d).exponential_(1.0, generator=g) / float(a.get("lam", 1.0)))
_like_sampler("_random_gamma_like", lambda g, s, d, a: _gamma(
    g, s, d, a.get("alpha", 1.0)) * float(a.get("beta", 1.0)))
_like_sampler("_random_poisson_like", lambda g, s, d, a: torch.poisson(
    torch.full(s, float(a.get("lam", 1.0)), device=d), generator=g))
_like_sampler("_random_negative_binomial_like", lambda g, s, d, a:
              _neg_binomial(g, s, d, float(a.get("k", 1.0)),
                            float(a.get("p", 0.5))))


def _gnb(g, s, d, a):
    alpha = max(float(a.get("alpha", 1.0)), 1e-6)
    return _neg_binomial(g, s, d, 1.0 / alpha,
                         1.0 / (1.0 + alpha * float(a.get("mu", 1.0))))


_like_sampler("_random_generalized_negative_binomial_like", _gnb)


@register("_sample_unique_zipfian", num_inputs=0, differentiable=False,
          num_outputs=2, no_trace=True)
def _sample_unique_zipfian(range_max=None, shape=None, ctx=None):
    """``shape[0]`` distinct candidates from a log-uniform (Zipfian)
    distribution over [0, range_max), and the number of draws it took:
    evaluated on the host, as the reference's, with numpy's generator
    seeded from the port's generator of ``ctx``."""
    dev = context.resolve(ctx)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator(dev),
                             device=dev).item())
    rng = np.random.RandomState(seed)
    n = int(shape[0]) if shape else 1
    rmax = int(range_max)
    out, seen, trials = [], set(), 0
    while len(out) < n and trials < 100 * n:
        v = int(np.exp(rng.rand() * np.log(rmax + 1.0)) - 1.0)
        trials += 1
        if v not in seen:
            seen.add(v)
            out.append(v)
    while len(out) < n:
        out.append(rng.randint(rmax))
    return (torch.tensor(out, dtype=torch.int64, device=dev),
            torch.tensor([trials], dtype=torch.int64, device=dev))


# -- multi-tensor and mixed-precision updates ----------------------------------

@register("multi_sum_sq", differentiable=False, num_outputs=None)
def _multi_sum_sq(*arrays, num_arrays=None):
    """The sum of squares of each array, a float32 scalar each."""
    return tuple(torch.square(a.float()).sum() for a in arrays)


@register("reset_arrays", differentiable=False, num_outputs=None)
def _reset_arrays(*arrays, num_arrays=None):
    """Zeros like each array: new tensors, nothing written in place."""
    return tuple(torch.zeros_like(a) for a in arrays)


@register("multi_lars", num_inputs=3, differentiable=False)
def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds=None, eta=0.001,
                eps=1e-8, rescale_grad=1.0):
    """LARS: each learning rate scaled by the trust ratio ``eta * |w| /
    (|g| + wd * |w| + eps)`` (1 where a norm is 0)."""
    wds = torch.zeros_like(lrs) if wds is None else torch.tensor(
        wds, dtype=torch.float32, device=lrs.device)
    wn = torch.sqrt(weights_sum_sq)
    gn = torch.sqrt(grads_sum_sq) * float(rescale_grad)
    trust = torch.where((wn > 0) & (gn > 0),
                        float(eta) * wn / (gn + wds * wn + float(eps)),
                        torch.ones((), dtype=wn.dtype, device=wn.device))
    return lrs * trust


@register("mp_nag_mom_update", num_inputs=4, differentiable=False,
          mutate_idx=(0, 2, 3))
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(weight32, grad.float(), wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * new_mom)
    return w32.to(weight.dtype), new_mom, w32


@register("mp_lamb_update_phase1", num_inputs=5, differentiable=False,
          mutate_idx=(2, 3))
def _mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                           beta2=0.999, epsilon=1e-6, t=1, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0,
                           bias_correction=True):
    """LAMB's first phase on the float32 master: (the update direction,
    the new mean, the new variance); the bias corrections are Python
    floats, as in the reference."""
    beta1, beta2 = float(beta1), float(beta2)
    g = grad.float() * float(rescale_grad)
    if float(clip_gradient) > 0:
        g = torch.clamp(g, -float(clip_gradient), float(clip_gradient))
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / (1 - beta1 ** int(t))
        v = v / (1 - beta2 ** int(t))
    return m / (torch.sqrt(v) + float(epsilon)) + float(wd) * weight32, \
        new_mean, new_var


@register("mp_lamb_update_phase2", num_inputs=5, differentiable=False,
          mutate_idx=(0,))
def _mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr=0.01,
                           lower_bound=-1.0, upper_bound=-1.0):
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    if lower_bound > 0:
        ratio = torch.clamp_min(ratio, lower_bound)
    if upper_bound > 0:
        ratio = torch.clamp_max(ratio, upper_bound)
    w32 = weight32 - lr * ratio * g
    return w32.to(weight.dtype), w32


@register("_mp_adamw_update", num_inputs=5, differentiable=False,
          mutate_idx=(0, 2, 3, 4))
def _mp_adamw_update(weight, grad, mean, var, weight32, lr=0.001, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                     rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.float() * float(rescale_grad)
    if float(clip_gradient) > 0:
        g = torch.clamp(g, -float(clip_gradient), float(clip_gradient))
    new_mean = float(beta1) * mean + (1 - float(beta1)) * g
    new_var = float(beta2) * var + (1 - float(beta2)) * torch.square(g)
    w32 = weight32 - float(eta) * (
        float(lr) * new_mean / (torch.sqrt(new_var) + float(epsilon))
        + float(wd) * weight32)
    return w32.to(weight.dtype), new_mean, new_var, w32


def _preloaded_groups(arrays, per_weight):
    """N groups of ``per_weight`` tensors, then the ``lrs`` and ``wds``
    vectors (the preloaded ops' flat inputs)."""
    nw = (len(arrays) - 2) // per_weight
    return [arrays[i * per_weight:(i + 1) * per_weight]
            for i in range(nw)], arrays[-2], arrays[-1]


@register("preloaded_multi_sgd_update", differentiable=False,
          num_outputs=None)
def _preloaded_multi_sgd_update(*arrays, num_weights=None, rescale_grad=1.0,
                                clip_gradient=-1.0):
    groups, lrs, wds = _preloaded_groups(arrays, 2)
    return tuple(w - lrs[i] * _apply_wd(w, g, wds[i], rescale_grad,
                                        clip_gradient)
                 for i, (w, g) in enumerate(groups))


@register("preloaded_multi_sgd_mom_update", differentiable=False,
          num_outputs=None)
def _preloaded_multi_sgd_mom_update(*arrays, num_weights=None, momentum=0.0,
                                    rescale_grad=1.0, clip_gradient=-1.0):
    """Per weight: ``mom = momentum * mom - lr_i * (g + wd_i * w)``, ``w +
    mom``; returns (weight, mom) for each, the learning rates and weight
    decays read from the last two inputs on the device."""
    groups, lrs, wds = _preloaded_groups(arrays, 3)
    outs = []
    for i, (w, g, m) in enumerate(groups):
        new_m = momentum * m - lrs[i] * _apply_wd(w, g, wds[i], rescale_grad,
                                                  clip_gradient)
        outs += [w + new_m, new_m]
    return tuple(outs)


@register("preloaded_multi_mp_sgd_update", differentiable=False,
          num_outputs=None)
def _preloaded_multi_mp_sgd_update(*arrays, num_weights=None,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    groups, lrs, wds = _preloaded_groups(arrays, 3)
    outs = []
    for i, (w, g, w32) in enumerate(groups):
        new_w32 = w32 - lrs[i] * _apply_wd(w32, g.float(), wds[i],
                                           rescale_grad, clip_gradient)
        outs += [new_w32.to(w.dtype), new_w32]
    return tuple(outs)


@register("preloaded_multi_mp_sgd_mom_update", differentiable=False,
          num_outputs=None)
def _preloaded_multi_mp_sgd_mom_update(*arrays, num_weights=None,
                                       momentum=0.0, rescale_grad=1.0,
                                       clip_gradient=-1.0):
    """The master-weight form: (weight in its own type, mom, float32
    master) for each."""
    groups, lrs, wds = _preloaded_groups(arrays, 4)
    outs = []
    for i, (w, g, m, w32) in enumerate(groups):
        new_m = momentum * m - lrs[i] * _apply_wd(w32, g.float(), wds[i],
                                                  rescale_grad, clip_gradient)
        new_w32 = w32 + new_m
        outs += [new_w32.to(w.dtype), new_m, new_w32]
    return tuple(outs)


@register("_contrib_group_adagrad_update", num_inputs=3,
          differentiable=False, mutate_idx=(0, 2))
def _group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """Row-wise AdaGrad: one history value a row (the mean square of its
    gradient), no weight decay."""
    g = grad * float(rescale_grad)
    if float(clip_gradient) > 0:
        g = torch.clamp(g, -float(clip_gradient), float(clip_gradient))
    dims = tuple(range(1, g.dim()))
    new_hist = history + (torch.square(g).mean(dim=dims) if dims
                          else torch.square(g))
    shape = (-1,) + (1,) * (g.dim() - 1)
    return weight - float(lr) * g / (torch.sqrt(new_hist).reshape(shape)
                                     + float(epsilon)), new_hist


# -- IdentityAttachKLSparseReg ----------------------------------------------------

class _KLSparseReg(torch.autograd.Function):
    """The identity forward; backward adds the gradient of ``penalty *
    sum KL(rho || rho_hat)``, ``rho_hat`` the batch mean of each unit
    (clipped into (0, 1))."""

    @staticmethod
    def forward(ctx, x, rho, penalty):
        rho_hat = torch.clamp(x.mean(dim=0), 1e-6, 1 - 1e-6)
        ctx.save_for_backward(rho_hat)
        ctx.rho, ctx.penalty, ctx.n = rho, penalty, x.shape[0]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (rho_hat,) = ctx.saved_tensors
        rho = torch.tensor(ctx.rho, dtype=torch.float32, device=g.device)
        penalty = torch.tensor(ctx.penalty, dtype=torch.float32,
                               device=g.device)
        kl = (penalty / ctx.n) * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + torch.broadcast_to(kl, g.shape), None, None


@register("IdentityAttachKLSparseReg", num_inputs=1)
def _identity_attach_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                                   momentum=0.9):
    """The sparse autoencoder's regulariser; ``momentum`` is accepted and
    unused (the reference uses the batch estimate, not a running one)."""
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


# -- _contrib_hawkesll ------------------------------------------------------------

@register("_contrib_hawkesll", num_inputs=7, num_outputs=2)
def _hawkesll(mu, alpha, beta, lags, marks, valid_length=None,
              max_time=None):
    """Log-likelihood of a multivariate Hawkes process with exponential
    kernels: mu, alpha, beta (K,); lags, marks (N, T); valid_length,
    max_time (N,).  Returns (log-likelihood (N,), the decayed states at
    the horizon (N, K)).  One loop over T, all N sequences at once; the
    states decay at every step, the clock and the likelihood advance at
    valid events only, as the reference's scan does."""
    k_types = mu.shape[0]
    n, t_len = lags.shape
    dev = lags.device
    marks = marks.long()
    lagsf = lags.float()
    vl = (torch.full((n,), t_len, device=dev) if valid_length is None
          else valid_length.long().reshape(-1))
    horizon = lagsf.sum(dim=1) if max_time is None else max_time.reshape(-1)
    states = torch.zeros((n, k_types), dtype=torch.float32, device=dev)
    counts = torch.zeros((n, k_types), dtype=torch.float32, device=dev)
    ll = torch.zeros((n,), dtype=torch.float32, device=dev)
    t_last = torch.zeros((n,), dtype=torch.float32, device=dev)
    for i in range(t_len):
        dt, k = lagsf[:, i], marks[:, i]
        states = states * torch.exp(-beta[None, :] * dt[:, None])
        lam = mu[k] + alpha[k] * beta[k] * states.gather(1, k[:, None])[:, 0]
        valid = vl > i
        ll = ll + torch.where(valid, torch.log(torch.clamp_min(lam, 1e-30)),
                              torch.zeros_like(lam))
        hit = torch.nn.functional.one_hot(k, k_types).to(states.dtype) \
            * valid[:, None].to(states.dtype)
        states = states + hit
        counts = counts + hit
        t_last = t_last + torch.where(valid, dt, torch.zeros_like(dt))
    states_t = states * torch.exp(-beta[None, :]
                                  * (horizon - t_last)[:, None])
    compensator = (mu[None, :] * horizon[:, None]).sum(dim=1) + (
        alpha[None, :] * (counts - states_t)).sum(dim=1)
    return ll - compensator, states_t

