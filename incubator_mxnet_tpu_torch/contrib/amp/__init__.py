"""``mx.contrib.amp`` (port of ``incubator_mxnet_tpu/contrib/amp``):
automatic mixed precision."""
from . import lists  # noqa: F401
from .amp import (convert_hybrid_block, convert_model, convert_symbol,
                  disable, init, init_trainer, list_fp32_ops, list_lp16_ops,
                  scale_loss, unscale)
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_symbol", "convert_hybrid_block", "list_lp16_ops",
           "list_fp32_ops", "disable", "LossScaler"]
