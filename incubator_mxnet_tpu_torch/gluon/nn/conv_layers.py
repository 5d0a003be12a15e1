"""Convolution and pooling layers (port of ``incubator_mxnet_tpu/gluon/nn/
conv_layers.py``): ``Conv1D``/``Conv2D``/``Conv3D``, their transposed
forms, the 1-D, 2-D and 3-D max, average and global pools and
``ReflectionPad2D``, channels first, as ``HybridBlock``s with the
reference's parameter names and initializers; each ``hybrid_forward`` is
the reference layer's symbolic body.  Channel-last layouts are refused
(ROADMAP A5d)."""
from __future__ import annotations

from ... import context
from ..block import Deferred, HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class _Conv(Deferred, HybridBlock):
    """An N-D convolution (``op_name="Convolution"``, weight (channels,
    in_channels / groups, k...)) or transposed convolution
    (``"Deconvolution"``, weight (in_channels, channels / groups, k...),
    ``adj`` padding the high edge), with an optional activation after
    it.  ``in_channels=0`` defers the weight's shape to the first
    input."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        n = len(kernel_size)
        if layout != _LAYOUTS[n]:
            raise ValueError("the port's %d-D convolutions are %s, got %r"
                             % (n, _LAYOUTS[n], layout))
        self._device = context.resolve(device)
        self._channels = channels
        self._groups = int(groups)
        self._op_name = op_name
        self._activation = activation
        self._kwargs = {"kernel": tuple(kernel_size),
                        "stride": _tuple(strides, n),
                        "dilate": _tuple(dilation, n),
                        "pad": _tuple(padding, n), "num_filter": channels,
                        "num_group": self._groups, "no_bias": not use_bias,
                        "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = _tuple(adj, n)
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
        k = self._kwargs["kernel"]
        if self._op_name == "Convolution":
            return (self._channels, in_channels // self._groups) + k
        return (in_channels, self._channels // self._groups) + k

    def _infer_shapes(self, x):
        return {"weight": self._weight_shape(x.shape[1])}

    def hybrid_forward(self, F, x, weight, bias=None):  # noqa: N803
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    """2-D convolution, weight (channels, in_channels / groups, kh, kw),
    with ``dilation``, ``groups`` and an optional activation after it."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        n = len(pool_size)
        self._kwargs = {
            "kernel": pool_size,
            "stride": _tuple(strides, n) if strides is not None
            else pool_size,
            "pad": _tuple(padding, n),
            "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        # as in the reference, an attribute of the average pools only
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool2D(_Pooling):
    """Max pooling through K3 on the card (``ops.pooling``);
    ``ceil_mode`` is MXNet's ``pooling_convention="full"``."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), (1,), (0,), False, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "max",
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), (1, 1, 1), (0, 0, 0), False, True, "max",
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), (1,), (0,), False, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "avg",
                         **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), (1, 1, 1), (0, 0, 0), False, True, "avg",
                         **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes of NCHW data by
    ``padding`` (an int pads each side alike; else the reference's flat
    (before, after) list, one pair an axis)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):  # noqa: N803
        return F.pad(x, mode="reflect", pad_width=self._padding)
