"""``mx.gluon.contrib.cnn`` (port of
``incubator_mxnet_tpu/gluon/contrib/cnn/__init__.py``):
``DeformableConvolution``.  The offsets come from a plain convolution;
the deformable sampling is the ``_contrib_DeformableConvolution`` op
(``ops/contrib_tail.py``)."""
from __future__ import annotations

from .... import context
from ...block import Deferred, HybridBlock

__all__ = ["DeformableConvolution"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class DeformableConvolution(Deferred, HybridBlock):
    """2-D deformable convolution (Dai et al. 2017): a convolution
    (``offset_weight``, ``offset_bias``, zeros by default) gives each
    output position's tap offsets, and the main convolution (``weight``,
    ``bias``) samples its input at the deformed positions.
    ``in_channels`` 0 defers the input width to the first input."""

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = context.resolve(device)
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._channels = int(channels)
        self._groups = int(groups)
        self._ndg = int(num_deformable_group)
        self._use_bias = bool(use_bias)
        self._activation = activation
        offset_channels = 2 * self._kernel[0] * self._kernel[1] * self._ndg
        with self.name_scope():
            self.offset_weight = self.params.get(
                "offset_weight",
                shape=(offset_channels, in_channels) + self._kernel,
                init=offset_weight_initializer, allow_deferred_init=True)
            self.offset_bias = self.params.get(
                "offset_bias", shape=(offset_channels,),
                init=offset_bias_initializer, allow_deferred_init=True)
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels) + self._kernel,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)

    def _infer_shapes(self, x):
        cin = x.shape[1]
        return {"offset_weight": (2 * self._kernel[0] * self._kernel[1]
                                  * self._ndg, cin) + self._kernel,
                "weight": (self._channels, cin) + self._kernel}

    def hybrid_forward(self, F, x, offset_weight, offset_bias, weight,  # noqa: N803
                       bias=None):
        offset = F.Convolution(x, offset_weight, offset_bias,
                               kernel=self._kernel, stride=self._strides,
                               pad=self._padding, dilate=self._dilation,
                               num_filter=offset_weight.shape[0])
        args = [x, offset, weight]
        if bias is not None:
            args.append(bias)
        out = F.contrib.DeformableConvolution(
            *args, kernel=self._kernel, stride=self._strides,
            pad=self._padding, dilate=self._dilation,
            num_filter=self._channels, num_group=self._groups,
            num_deformable_group=self._ndg, no_bias=bias is None)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out
