"""The port's argmax-carrying max pool (``incubator_mxnet_tpu_torch/
parallel/maxpool_idx.py``) against the JAX package's, on the CPU.

The forward's pooled values and int8 winner plane must equal the
reference kernel's (``maxpool_with_index``, Pallas in interpret mode)
exactly, on tie-heavy inputs (values on a coarse grid, half of them
clipped to 0 as after a ReLU); ``indexed_unpool`` must equal the
reference's exactly; the autograd path of the pooling op must give the
reference pooling op's gradient exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu.ops.nn as jops
from incubator_mxnet_tpu.parallel import maxpool_idx as jmp

from incubator_mxnet_tpu_torch.ops import nn as tops
from incubator_mxnet_tpu_torch.parallel import maxpool_idx as tmp

CASES = [
    # the stem pattern (3x3 s2 p1) with floor slack
    ((4, 8, 12, 12), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 16, 16, 16), (3, 3), (2, 2), ((1, 1), (1, 1))),
    # non-overlapping, no padding, odd extent
    ((3, 8, 9, 9), (2, 2), (2, 2), ((0, 0), (0, 0))),
    # stride-1 overlap: every input position in up to 9 windows
    ((2, 4, 7, 7), (3, 3), (1, 1), ((1, 1), (1, 1))),
    # ceil-mode ("full") high-edge padding
    ((2, 4, 8, 8), (3, 3), (2, 2), ((1, 2), (1, 2))),
]


def _configs(win, stride, pad):
    return (1, 1) + win, (1, 1) + stride, ((0, 0), (0, 0)) + pad


def _tie_heavy(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = np.round(rng.normal(size=shape) * 2) / 2
    return np.maximum(x, 0).astype(np.float32)


@pytest.mark.parametrize("shape,win,stride,pad", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_equals_reference(shape, win, stride, pad, dtype):
    window, strides, padding = _configs(win, stride, pad)
    x = _tie_heavy(shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    plan = jmp.plan(shape, jnp.dtype(jdt).itemsize, window, strides, padding)
    jout, jidx = jmp.maxpool_with_index(jnp.asarray(x, jdt), window, strides,
                                        padding, plan)
    tout, tidx = tmp.maxpool_with_index(
        torch.from_numpy(x).to(getattr(torch, dtype)), window, strides,
        padding)
    assert tidx.dtype == torch.int8
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout, np.float32))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("shape,win,stride,pad", CASES)
def test_indexed_unpool_equals_reference(shape, win, stride, pad):
    window, strides, padding = _configs(win, stride, pad)
    x = _tie_heavy(shape, seed=1)
    plan = jmp.plan(shape, 4, window, strides, padding)
    jout, jidx = jmp.maxpool_with_index(jnp.asarray(x), window, strides,
                                        padding, plan)
    g = np.random.RandomState(2).normal(size=jout.shape).astype(np.float32)
    jdx = jmp.indexed_unpool(jidx, jnp.asarray(g), shape, window, strides,
                             padding)
    tdx = tmp.indexed_unpool(torch.from_numpy(np.array(jidx)),
                             torch.from_numpy(g), shape, window, strides,
                             padding)
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))


def test_pooling_op_grad_equals_reference():
    """``ops.nn.pooling`` (max, 3x3/2/1) forward and input gradient
    against the reference ``Pooling`` op under ``jax.vjp``."""
    shape = (2, 8, 12, 12)
    x = _tie_heavy(shape, seed=3)
    g = np.random.RandomState(4).normal(size=(2, 8, 6, 6)).astype(np.float32)
    kw = dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1))
    jout, vjp = jax.vjp(lambda a: jops._pooling(a, **kw), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    tout = tops.pooling(xt, **kw)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("window,strides,padding", [
    ((1, 1, 1, 1), (1, 1, 1, 1), ((0, 0),) * 4),           # 1 slot
    ((1, 1, 12, 12), (1, 1, 1, 1), ((0, 0),) * 4),         # 144 slots
    ((2, 1, 3, 3), (1, 1, 2, 2), ((0, 0),) * 4),           # pools over N
])
def test_shape_rules_of_reference_plan(window, strides, padding):
    shape = (2, 4, 12, 12)
    assert jmp.plan(shape, 4, window, strides, padding) is None
    with pytest.raises(ValueError):
        tmp.check_shape(shape, window, strides, padding)


def test_nan_propagates_and_keeps_slot():
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 1, 1] = np.nan
    x[0, 0, 0, 1] = 3.0
    window, strides, padding = _configs((3, 3), (2, 2), ((1, 1), (1, 1)))
    plan = jmp.plan(x.shape, 4, window, strides, padding)
    jout, jidx = jmp.maxpool_with_index(jnp.asarray(x), window, strides,
                                        padding, plan)
    tout, tidx = tmp.maxpool_with_index(torch.from_numpy(x), window, strides,
                                        padding)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
