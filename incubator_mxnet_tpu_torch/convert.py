"""Carry weights between the JAX package's nets and the port's.

Gluon names carry global counters (``conv2d0_weight``, ...) that shift
between nets built in one process, so the match is by position: the
JAX net's ``collect_params()`` order, running stats included, against
the port's modules in construction order, each module's parameters then
its buffers.  The port builds its modules in the reference's
registration order, so the two orders agree; shapes are checked.

The long-context LM's parameters are a nested dict whose keys are stable
(``embed``; ``l0`` ... ``lN`` with ``ln1_g ln1_b wq wk wv wo ln2_g ln2_b
w1 w2``; ``out``), so they are matched by key.  Not by position:
``jax.tree.leaves`` sorts dict keys, and its order is not the
construction order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ordered_tensors", "params_from_jax", "params_to_numpy",
           "lm_params_from_jax", "lm_params_to_numpy"]


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


def _lm_tree(lm):
    """The LM's parameters as the example's nested dict: ``l0.wq`` becomes
    ``{"l0": {"wq": ...}}``."""
    tree = {}
    for name, p in lm.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def lm_params_from_jax(lm, tree):
    """Load ``tree`` (the example's nested dict of arrays, jax or numpy)
    into the parameters of ``lm`` by key, in place.  Missing or
    extra keys and shape mismatches raise."""

    def copy(name, dst, src):
        a = np.array(src, np.float32)
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError("%s has shape %s, the array %s"
                             % (name, tuple(dst.shape), a.shape))
        dst.copy_(torch.from_numpy(a).to(dst.dtype))

    def walk(prefix, dst, src):
        if set(dst) != set(src):
            raise ValueError("%skeys %s, the tree has %s"
                             % (prefix, sorted(dst), sorted(src)))
        for key, t in dst.items():
            if isinstance(t, dict):
                walk(prefix + key + ".", t, src[key])
            else:
                copy(prefix + key, t, src[key])

    with torch.no_grad():
        walk("", _lm_tree(lm), tree)
    return lm


def lm_params_to_numpy(lm):
    """Copies of the LM's parameters as the example's nested dict of
    float32 numpy arrays."""

    def walk(node):
        return {k: walk(t) if isinstance(t, dict)
                else t.detach().float().cpu().numpy().copy()
                for k, t in node.items()}

    return walk(_lm_tree(lm))
