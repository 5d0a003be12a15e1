"""Carry weights between the JAX package's nets and the port's.

Gluon names carry global counters (``conv2d0_weight``, ...) that shift
between nets built in one process, so the match is by position: the
JAX net's ``collect_params()`` order, running stats included, against
the port's modules in construction order, each module's parameters then
its buffers.  The port builds its modules in the reference's
registration order, so the two orders agree; shapes are checked.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ordered_tensors", "params_from_jax", "params_to_numpy"]


def ordered_tensors(net):
    """``[(name, tensor)]``: parameters and buffers in the reference's
    ``collect_params()`` order."""
    out = []
    for prefix, mod in net.named_modules():
        for kind in (mod._parameters, mod._buffers):
            for name, t in kind.items():
                if t is not None:
                    out.append(((prefix + "." if prefix else "") + name, t))
    return out


def params_from_jax(net, arrays):
    """Load ``arrays`` (numpy, in ``collect_params()`` order: the values
    of the reference net's ``collect_params()``, or
    :func:`params_to_numpy` of another port net) into ``net``'s
    parameters and buffers, in place."""
    arrays = list(arrays)
    tensors = ordered_tensors(net)
    if len(arrays) != len(tensors):
        raise ValueError("%d arrays for %d parameters and buffers"
                         % (len(arrays), len(tensors)))
    with torch.no_grad():
        for (name, t), a in zip(tensors, arrays):
            a = np.asarray(a)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError("%s has shape %s, the array %s"
                                 % (name, tuple(t.shape), a.shape))
            t.copy_(torch.from_numpy(np.array(a, np.float32)).to(t.dtype))
    return net


def params_to_numpy(net):
    """Copies of the parameters and buffers of ``net`` as float32 numpy
    arrays, in the same order."""
    return [t.detach().float().cpu().numpy().copy()
            for _, t in ordered_tensors(net)]
