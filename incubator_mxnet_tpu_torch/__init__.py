"""PyTorch and CUDA port of ``incubator_mxnet_tpu`` for NVIDIA Hopper.

The JAX package is the reference and this package never imports it, nor
``jax``.  Its entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The kernels that the JAX package wrote in Pallas are
hand-written CUDA here (``csrc/``), built at first use by ``_kernels``;
user kernels given as CUDA C at run time compile with NVRTC (``rtc``).

The imperative API keeps the reference's names: ``mx.nd`` (NDArray and
its operators), ``mx.autograd``, ``mx.random``, ``mx.cpu()``/``mx.gpu()``,
and the input path: ``mx.recordio`` and the iterators of ``mx.io``.
"""
from . import (autograd, context, gluon, initializer, io, ndarray, parallel,
               random, recordio, rtc)
from . import ndarray as nd
from .context import cpu, gpu
from .ndarray import NDArray

__all__ = ["autograd", "context", "gluon", "initializer", "io", "ndarray",
           "nd", "parallel", "random", "recordio", "rtc", "cpu", "gpu",
           "NDArray"]
