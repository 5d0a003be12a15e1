"""Dynamic loss scaling (port of ``incubator_mxnet_tpu/contrib/amp/
loss_scaler.py``).  float16 needs it; bfloat16 has float32's exponent
range, so ``amp.init()`` starts its scaler at 1 there."""
from __future__ import annotations

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.**16, scale_factor=2., scale_window=2000,
                 tolerance=0.05, max_loss_scale=2.**24):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._max_loss_scale = max_loss_scale
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient of ``params`` (Parameters with a gradient,
        or NDArrays) is not finite: one ``multi_all_finite`` over them all
        and one read of its flag on the host."""
        from ...ndarray import NDArray
        from ...ops.registry import invoke

        grads = []
        for p in params:
            if getattr(p, "grad_req", "write") == "null":
                continue
            grad = p.grad() if callable(getattr(p, "grad", None)) else p
            if isinstance(grad, NDArray):
                grads.append(grad)
        if not grads:
            return False
        ok = invoke("multi_all_finite", grads, num_arrays=len(grads))
        return not bool(ok.asnumpy().item())

    def update_scale(self, overflow):
        """Halve on overflow (not below 1); double after ``scale_window``
        clean steps in a row, up to ``max_loss_scale``."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      self._max_loss_scale)
                self._unskipped = 0
