"""PyTorch and CUDA port of ``incubator_mxnet_tpu`` for NVIDIA Hopper.

The JAX package is the reference and this package never imports it, nor
``jax``.  Its entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The kernels that the JAX package wrote in Pallas are
hand-written CUDA here (``csrc/``), built at first use by ``_kernels``;
user kernels given as CUDA C at run time compile with NVRTC (``rtc``).

The imperative API keeps the reference's names: ``mx.nd`` (NDArray and
its operators), ``mx.autograd``, ``mx.random``, ``mx.cpu()``/``mx.gpu()``,
the input path (``mx.recordio`` and the iterators of ``mx.io``) and the
Gluon training surface: ``mx.gluon`` (``Parameter``, ``Block``/
``HybridBlock``, ``Trainer``, layers, losses, the model zoo),
``mx.init``, ``mx.optimizer``, ``mx.lr_scheduler``, ``mx.metric`` and
``mx.kv``; and the symbolic path: ``mx.sym`` (graphs of the registered
ops), the ``Executor`` that ``bind``/``simple_bind`` make, ``mx.mod``
(``Module``), ``mx.model`` (checkpoints), ``mx.callback``,
``mx.monitor``, ``mx.name`` and ``mx.attribute``; and the recurrent
path: the fused ``RNN`` op, ``mx.gluon.rnn``, the legacy ``mx.rnn`` cells
with ``BucketSentenceIter``, and ``mx.mod.BucketingModule``; and
detection: the multibox, NMS and ROI ops (``mx.nd.contrib``,
``mx.sym.contrib``), ``mx.image`` with ``ImageDetIter``, and
``mx.io.ImageDetRecordIter``; and int8: the quantization ops and
``mx.contrib.quantization`` (BN folding, the graph rewrite, calibration);
and the NumPy frontend: ``mx.np`` (with ``linalg`` and ``random``),
``mx.npx`` and ``mx.util``'s NumPy-semantics switches; and
``mx.operator``: custom operators written in Python, run by the
``Custom`` op.
"""
from . import ops  # noqa: F401  (first: parallel.train_step imports ndarray)
from . import (attribute, autograd, callback, context, contrib, executor,
               gluon, image, initializer, io, kvstore, lr_scheduler, metric,
               model, module, monitor, name, ndarray, operator, optimizer,
               parallel, random, recordio, rnn, rtc, symbol, tracing, util)
from . import numpy as np  # noqa: A004  (mx.np)
from . import numpy_extension as npx
from . import initializer as init
from . import kvstore as kv
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .context import cpu, gpu
from .ndarray import NDArray
from .util import is_np_array, reset_np, set_np

__all__ = ["attribute", "autograd", "callback", "context", "contrib",
           "executor", "gluon", "image", "init", "initializer", "io", "kv",
           "kvstore", "lr_scheduler", "metric", "mod", "model", "module", "monitor",
           "name", "ndarray", "nd", "operator", "optimizer", "parallel", "random",
           "recordio", "rnn", "rtc", "sym", "symbol", "tracing", "cpu", "gpu",
           "NDArray", "np", "npx", "util", "is_np_array", "reset_np",
           "set_np"]
