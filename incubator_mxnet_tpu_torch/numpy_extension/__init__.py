"""``mx.npx`` (port of ``incubator_mxnet_tpu/numpy_extension``): the
operator-style extras of the NumPy frontend over the registry, and the
NumPy-semantics switches of ``util``.  Each call goes through
``ops.registry.invoke``, so it records under ``autograd.record()`` and
routes as ``mx.nd`` does (``pooling(pool_type="max")`` launches K3 on
the card)."""
from __future__ import annotations

from ..ops import registry as _reg
from ..util import is_np_array, is_np_shape, reset_np, set_np

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "softmax",
           "log_softmax", "relu", "sigmoid", "batch_norm", "fully_connected",
           "convolution", "pooling", "one_hot", "pick", "topk", "reshape_like",
           "batch_dot", "gamma", "seed"]


def _invoke(opname, tensors, **kw):
    return _reg.invoke(opname, list(tensors), **kw)


def softmax(data, axis=-1, **kw):
    return _invoke("softmax", [data], axis=axis)


def log_softmax(data, axis=-1, **kw):
    return _invoke("log_softmax", [data], axis=axis)


def relu(data):
    return _invoke("relu", [data])


def sigmoid(data):
    return _invoke("sigmoid", [data])


def batch_norm(x, gamma, beta, running_mean, running_var, **kw):
    return _invoke("BatchNorm", [x, gamma, beta, running_mean, running_var],
                   **kw)


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    return _invoke("FullyConnected", [x, weight, bias], num_hidden=num_hidden,
                   no_bias=no_bias, flatten=flatten)


def convolution(data=None, weight=None, bias=None, **kw):
    return _invoke("Convolution", [data, weight, bias], **kw)


def pooling(data=None, **kw):
    return _invoke("Pooling", [data], **kw)


def one_hot(data, depth=None, **kw):
    return _invoke("one_hot", [data], depth=depth, **kw)


def pick(data, index, axis=-1, **kw):
    return _invoke("pick", [data, index], axis=axis, **kw)


def topk(data, k=1, axis=-1, **kw):
    return _invoke("topk", [data], k=k, axis=axis, **kw)


def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    return _invoke("batch_dot", [a, b], transpose_a=transpose_a,
                   transpose_b=transpose_b)


def gamma(data):
    return _invoke("gamma", [data])


def seed(s):
    from .. import random

    random.seed(s)
