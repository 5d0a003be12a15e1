"""The imperative slice as a whole, on the CPU: one causal attention
layer written with ``nd`` and ``autograd`` alone (``chip_smoke.py``'s
[3c] layer: ``nd.dot``, reshape/transpose to heads,
``nd.contrib.flash_attention``, back, ``nd.dot`` with Wo, ``(y * y).mean()``,
``backward``), at batch 2, seq 32, dim 32, 4 heads, through the JAX
package (its Pallas flash attention in interpret mode) and through the
port (the kernels' plain versions).  Loss, output and the four weight
gradients agree within rtol 1e-4, atol 1e-6 in float32.
"""
import importlib.util
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-6


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(batch=2, seq=32, dim=32):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((batch, seq, dim)).astype(np.float32)
    bound = dim ** -0.5
    w = {n: rng.uniform(-bound, bound, (dim, dim)).astype(np.float32)
         for n in ("wq", "wk", "wv", "wo")}
    return x, w


def _run(mx, ctx, x, w, heads, grad_req="write", steps=1):
    arr = (lambda v: mx.nd.array(v, ctx=ctx)) if ctx is not None \
        else mx.nd.array
    wn = {n: arr(v) for n, v in w.items()}
    for p in wn.values():
        p.attach_grad(grad_req)
    layer = _smoke().nd_attention_layer
    for _ in range(steps):
        loss, y, a = layer(mx, arr(x), wn, heads)
    return (loss.asnumpy(), y.asnumpy(), a.asnumpy(),
            {n: p.grad.asnumpy() for n, p in wn.items()})


@pytest.mark.parametrize("heads", [4, 2])
def test_nd_layer_matches_the_jax_package(heads):
    x, w = _inputs()
    before = _kernels.launch_counts()
    t_loss, t_y, t_a, t_g = _run(tmx, tmx.cpu(), x, w, heads)
    assert _kernels.launch_counts() == before     # CPU: plain versions only
    j_loss, j_y, j_a, j_g = _run(jmx, None, x, w, heads)
    for got, want in ((t_loss, j_loss), (t_y, j_y), (t_a, j_a)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for n in w:
        assert t_g[n].dtype == j_g[n].dtype == np.float32
        np.testing.assert_allclose(t_g[n], j_g[n], rtol=RTOL, atol=ATOL)


def test_nd_layer_grad_add_accumulates_like_the_reference():
    x, w = _inputs(seq=16, dim=16)
    t = _run(tmx, tmx.cpu(), x, w, 4, grad_req="add", steps=2)[3]
    j = _run(jmx, None, x, w, 4, grad_req="add", steps=2)[3]
    one = _run(tmx, tmx.cpu(), x, w, 4)[3]
    for n in w:
        np.testing.assert_allclose(t[n], j[n], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t[n], 2 * one[n], rtol=1e-6, atol=1e-7)
