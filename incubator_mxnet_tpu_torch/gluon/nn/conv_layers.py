"""Convolution and pooling layers (port of ``incubator_mxnet_tpu/gluon/nn/
conv_layers.py``): ``Conv2D``, ``MaxPool2D``, ``AvgPool2D``,
``GlobalMaxPool2D`` and ``GlobalAvgPool2D``, NCHW, as ``HybridBlock``s
with the reference's parameter names and initializers; each
``hybrid_forward`` is the reference layer's symbolic body."""
from __future__ import annotations

from ... import context
from ..block import Deferred, HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(Deferred, HybridBlock):
    """2-D convolution, weight (channels, in_channels / groups, kh, kw),
    with ``dilation``, ``groups`` and an optional activation after it.
    ``in_channels=0`` defers the weight's shape to the first input."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        if layout != "NCHW":
            raise ValueError("the port's Conv2D is NCHW, got %r" % layout)
        self._device = context.resolve(device)
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._stride = _pair(strides)
        self._pad = _pair(padding)
        self._dilate = _pair(dilation)
        self._groups = int(groups)
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None

    def _weight_shape(self, in_channels):
        return (self._channels, in_channels // self._groups) + self._kernel

    def _infer_shapes(self, x):
        return {"weight": self._weight_shape(x.shape[1])}

    def hybrid_forward(self, F, x, weight, bias=None):  # noqa: N803
        out = F.Convolution(x, weight, bias, kernel=self._kernel,
                            stride=self._stride, dilate=self._dilate,
                            pad=self._pad, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None,
                            layout="NCHW")
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {
            "kernel": _pair(pool_size),
            "stride": _pair(strides) if strides is not None
            else _pair(pool_size),
            "pad": _pair(padding),
            "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        # as in the reference, an attribute of the average pools only
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    """Max pooling through K3 on the card (``ops.pooling``);
    ``ceil_mode`` is MXNet's ``pooling_convention="full"``."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "max",
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "avg",
                         count_include_pad, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "max",
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "avg",
                         **kwargs)
