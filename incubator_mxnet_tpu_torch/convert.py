"""Carry weights between the JAX package's nets and the port's.

Gluon names carry global counters (``conv2d0_weight``, ...) that shift
between nets built in one process, so the match is by position: the
JAX net's ``collect_params()`` order, running stats included, against
the port's modules in construction order, each module's parameters then
its buffers.  The port builds its modules in the reference's
registration order, so the two orders agree; shapes are checked.  A
parameter without gradient (a BN's gamma with ``scale=False``) keeps its
place among the parameters, as in ``collect_params()``.  A net whose
layers defer their widths is resolved first (``gluon.shape_init``).

:func:`params_from_gluon` is the copy by name: the reference net's
``collect_params()`` as ``{name: array}`` into the port net's
``collect_params()``.  A name's counters (``conv2d17_``) count every
block built before it in its process, so each package's names are
first renumbered from the net's own first block of each kind
(:func:`canonical_names`); the nets' structures must agree.

The long-context LM's parameters are a nested dict whose keys are stable
(``embed``; ``l0`` ... ``lN`` with ``ln1_g ln1_b wq wk wv wo ln2_g ln2_b
w1 w2``; ``out``), so they are matched by key.  Not by position:
``jax.tree.leaves`` sorts dict keys, and its order is not the
construction order.  The serving decoder's (``serve.TinyDecoderLM``) are
the same kind of tree, with a list of blocks, and are matched by key and
index (:func:`decoder_params_from_jax`).
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["ordered_tensors", "params_from_jax", "params_to_numpy",
           "canonical_names", "params_from_gluon",
           "lm_params_from_jax", "lm_params_to_numpy", "ndarrays_from_numpy",
           "decoder_params_from_jax"]


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


_COUNTED = re.compile(r"([a-z_][a-z0-9_]*?)(\d+)_")


def canonical_names(names):
    """``names`` with each prefix counter (``conv2d17_``) renumbered by the
    order in which ``names`` first show that kind's counters, so two
    nets of one structure built at different counter states get the same
    names (``conv2d0_weight``, ``conv2d1_weight``, ...)."""
    seen = {}

    def renumber(m):
        hint, n = m.group(1), int(m.group(2))
        ids = seen.setdefault(hint, {})
        return "%s%d_" % (hint, ids.setdefault(n, len(ids)))

    return [_COUNTED.sub(renumber, n) for n in names]


def params_from_gluon(net, arrays):
    """Copy ``arrays`` (``{name: numpy}``, e.g. the reference net's
    ``{k: p.data().asnumpy() for k, p in collect_params().items()}``,
    running stats included) into ``net``'s parameters by name, after
    :func:`canonical_names` on both sides.  Missing or extra names and
    shape mismatches raise."""
    params = net.collect_params()
    mine = dict(zip(canonical_names(list(params.keys())), params.values()))
    theirs = dict(zip(canonical_names(list(arrays)), arrays.values()))
    if set(mine) != set(theirs):
        raise ValueError("names differ: %s only in the net, %s only in the "
                         "arrays" % (sorted(set(mine) - set(theirs))[:4],
                                     sorted(set(theirs) - set(mine))[:4]))
    for name, p in mine.items():
        a = np.asarray(theirs[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError("%s has shape %s, the array %s"
                             % (name, p.shape, a.shape))
        p.set_data(torch.from_numpy(np.array(a, np.float32)))
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


def ndarrays_from_numpy(arrays, ctx=None):
    """``{name: numpy}`` (the JAX package's ``{name: NDArray.asnumpy()}``)
    as ``{name: NDArray}`` of the port on ``ctx`` (``None``: the default
    CUDA card), each in its own dtype."""
    from .ndarray import array

    return {k: array(np.asarray(v), ctx) for k, v in arrays.items()}


def decoder_params_from_jax(lm, tree, device=None):
    """The JAX package's ``TinyDecoderLM`` parameter tree (its nested dict
    of arrays, jax or numpy: ``embed``, ``pos``, ``blocks`` as a list of
    dicts, ``ln_f``, ``head``) as the port's decoder takes it: the same
    tree of float32 tensors on ``device`` (``None``: the card).  Keys,
    block counts and shapes are checked against ``lm.param_shapes()``."""
    from . import context

    device = context.resolve(device)

    def walk(name, shapes, src):
        if isinstance(shapes, dict):
            if not isinstance(src, dict) or set(shapes) != set(src):
                raise ValueError("%s: keys %s, the tree has %s"
                                 % (name or "root", sorted(shapes),
                                    sorted(src) if isinstance(src, dict)
                                    else type(src).__name__))
            return {k: walk(name + k + ".", v, src[k])
                    for k, v in shapes.items()}
        if isinstance(shapes, list):
            if len(src) != len(shapes):
                raise ValueError("%s: %d blocks, the tree has %d"
                                 % (name, len(shapes), len(src)))
            return [walk("%s%d." % (name, i), v, b)
                    for i, (v, b) in enumerate(zip(shapes, src))]
        a = np.array(src, np.float32)
        if tuple(a.shape) != tuple(shapes):
            raise ValueError("%s has shape %s, the array %s"
                             % (name[:-1], tuple(shapes), a.shape))
        return torch.from_numpy(a).to(device)

    return walk("", lm.param_shapes(), tree)
