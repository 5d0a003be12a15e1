"""Gluon (port of ``incubator_mxnet_tpu/gluon``): ``Parameter``,
``ParameterDict``, ``Constant``, ``Block``/``HybridBlock`` over
``torch.nn.Module`` with ``export``, ``SymbolBlock``, ``Trainer``, the layers, the recurrent layers and
cells (``gluon.rnn``), ``gluon.contrib`` (the Estimator, contrib layers
and cells, ``MoEFFN``), losses, the data pipeline (``gluon.data``), the
model zoo and ``gluon.utils``."""
from . import (block, contrib, data, loss, model_zoo, nn, parameter, rnn,
               trainer, utils)
from .block import Block, HybridBlock, SymbolBlock, shape_init
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "Constant", "DeferredInitializationError",
           "Trainer", "block", "contrib", "data", "loss", "model_zoo", "nn", "parameter", "rnn",
           "trainer", "shape_init", "utils"]
