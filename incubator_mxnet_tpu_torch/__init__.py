"""PyTorch and CUDA port of ``incubator_mxnet_tpu`` for NVIDIA Hopper.

The JAX package is the reference and this package never imports it, nor
``jax``.  Its entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The kernels that the JAX package wrote in Pallas are
hand-written CUDA here (``csrc/``), built at first use by ``_kernels``.
"""
from . import context, gluon, initializer, parallel

__all__ = ["context", "gluon", "initializer", "parallel"]
