"""The port's last 23 layers of ``gluon.nn`` against the JAX package's, on
the CPU: the norms (``InstanceNorm``, ``LayerNorm``, ``GroupNorm``), the
1-D and 3-D convolutions, the transposed convolutions, the 1-D and 3-D
pools, ``ReflectionPad2D`` and the activations (``LeakyReLU``, ``PReLU``,
``ELU``, ``SELU``, ``GELU``, ``Swish``).

Each layer is built in both packages with deferred widths (resolved by
the port's ``shape_init``) and given the same numpy-drawn parameters by
name.  The port's layer runs forward under ``record()`` on NDArrays and
backward from a random cotangent; the reference's ``hybrid_forward``
runs on the same arrays over its registered ops (``invoke_raw``, as its
traced programs call them), differentiated by ``jax.value_and_grad`` in
one ``jax.jit`` of every case (eager JAX compiles each op of each layer
apart).  The output, the input's gradient and every trained parameter's
gradient are held within 1e-5 (``rtol`` and ``atol``; both sides compute
in float32).  The parameter names, shapes and ``grad_req`` are the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.block import _BlockScope as _JScope
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import context, convert
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.block import _BlockScope as _TScope

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)

#: case -> (class name, constructor keywords, input shape)
LAYERS = {
    "InstanceNorm": ("InstanceNorm", dict(scale=True), (2, 3, 5, 4)),
    "InstanceNorm-default": ("InstanceNorm", {}, (2, 3, 6)),
    "LayerNorm": ("LayerNorm", {}, (3, 4, 6)),
    "LayerNorm-axis1": ("LayerNorm", dict(axis=1, epsilon=1e-3),
                        (2, 5, 3)),
    "GroupNorm": ("GroupNorm", dict(num_groups=2), (2, 4, 3, 3)),
    "Conv1D": ("Conv1D", dict(channels=4, kernel_size=3, strides=2,
                              padding=1, activation="relu"), (2, 3, 9)),
    "Conv1D-groups-dilation": ("Conv1D", dict(channels=4, kernel_size=2,
                                              dilation=2, groups=2,
                                              use_bias=False), (2, 4, 7)),
    "Conv3D": ("Conv3D", dict(channels=3, kernel_size=(2, 3, 2),
                              padding=(1, 1, 0)), (1, 2, 4, 5, 4)),
    "Conv1DTranspose": ("Conv1DTranspose", dict(
        channels=3, kernel_size=4, strides=2, padding=1), (2, 2, 5)),
    "Conv2DTranspose": ("Conv2DTranspose", dict(
        channels=4, kernel_size=3, strides=2, padding=1, output_padding=1,
        activation="tanh"), (2, 3, 4, 4)),
    "Conv2DTranspose-groups": ("Conv2DTranspose", dict(
        channels=4, kernel_size=3, strides=2, groups=2), (1, 4, 3, 3)),
    "Conv3DTranspose": ("Conv3DTranspose", dict(
        channels=2, kernel_size=2, strides=2, use_bias=False),
        (1, 3, 2, 3, 2)),
    "MaxPool1D": ("MaxPool1D", dict(pool_size=3, strides=2, padding=1,
                                    ceil_mode=True), (2, 3, 8)),
    "MaxPool3D": ("MaxPool3D", {}, (1, 2, 4, 4, 6)),
    "AvgPool1D": ("AvgPool1D", dict(pool_size=3, padding=1,
                                    count_include_pad=False), (2, 3, 7)),
    "AvgPool3D": ("AvgPool3D", dict(pool_size=(2, 2, 3), strides=1,
                                    ceil_mode=True), (1, 2, 3, 4, 5)),
    "GlobalMaxPool1D": ("GlobalMaxPool1D", {}, (2, 3, 7)),
    "GlobalMaxPool3D": ("GlobalMaxPool3D", {}, (2, 3, 2, 3, 4)),
    "GlobalAvgPool1D": ("GlobalAvgPool1D", {}, (2, 3, 7)),
    "GlobalAvgPool3D": ("GlobalAvgPool3D", {}, (2, 3, 2, 3, 4)),
    "ReflectionPad2D": ("ReflectionPad2D", dict(padding=2), (1, 2, 4, 5)),
    "LeakyReLU": ("LeakyReLU", dict(alpha=0.2), (3, 5)),
    "PReLU": ("PReLU", {}, (2, 3, 4)),
    "ELU": ("ELU", dict(alpha=0.5), (3, 5)),
    "SELU": ("SELU", {}, (3, 5)),
    "GELU": ("GELU", {}, (3, 5)),
    "Swish": ("Swish", dict(beta=1.5), (3, 5)),
}


def _build(cls, kw):
    _JScope._state.counter = {}
    _TScope._state.counter = {}
    j = getattr(jnn, cls)(**kw)
    with context.device_scope("cpu"):
        t = getattr(tnn, cls)(**kw)
    return j, t


class _RawOps:
    """``F`` for a reference layer's ``hybrid_forward`` on jax arrays:
    its registered ops through ``registry.invoke_raw``, as the
    reference's traced programs call them."""

    def __getattr__(self, name):
        op = jreg.get_op(name)
        return lambda *args, **attrs: jreg.invoke_raw(op, args, **attrs)


def _cotangent(seed, shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _prepare(case):
    """Both blocks, the input, and the same numpy-drawn weights by name
    in the port's (the port resolves the deferred shapes)."""
    cls, kw, shape = LAYERS[case]
    jblock, tblock = _build(cls, kw)
    seed = sum(map(ord, case))
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    tmx.gluon.shape_init(tblock, shape)
    weights = {k: rng.uniform(-0.5, 0.5, tuple(p.shape)).astype(np.float32)
               for k, p in tblock.collect_params().items()}
    convert.params_from_gluon(tblock, weights)
    return dict(jblock=jblock, tblock=tblock, x=x, weights=weights,
                seed=seed + 1)


_CASES = {}


def _reference_all():
    """Every case's reference output, input gradient and parameter
    gradients: each layer's ``hybrid_forward`` over the reference's ops
    (on its parameters by attribute name) differentiated in one
    ``jax.jit`` of all the cases, compiled once for the module."""
    if _CASES:
        return _CASES
    preps = {c: _prepare(c) for c in sorted(LAYERS)}
    F = _RawOps()

    def forward(c, x, params):
        blk = preps[c]["jblock"]
        return blk.hybrid_forward(F, x, **{
            attr: params[p.name] for attr, p in blk._reg_params.items()})

    inputs = {c: (p["x"], p["weights"]) for c, p in preps.items()}
    cots = {c: _cotangent(p["seed"], jax.eval_shape(
        lambda x, w, c=c: forward(c, x, w), *inputs[c]).shape)
        for c, p in preps.items()}

    def all_cases(inputs):
        res = {}
        for c, (x, params) in inputs.items():
            def proj(x, params, c=c):
                out = forward(c, x, params)
                return jnp.sum(out * cots[c]), out
            (_, out), grads = jax.value_and_grad(
                proj, argnums=(0, 1), has_aux=True)(x, params)
            res[c] = (out, grads[0], grads[1])
        return res

    for c, (out, dx, dparams) in jax.jit(all_cases)(inputs).items():
        req = {k: p.grad_req for k, p in
               preps[c]["jblock"].collect_params().items()}
        _CASES[c] = dict(preps[c], want=np.asarray(out),
                         want_dx=np.asarray(dx),
                         want_g={k: np.asarray(g) for k, g in dparams.items()
                                 if req[k] != "null"})
    return _CASES


def _run(block, x, seed):
    """The port's output, input gradient and parameter gradients of
    ``block`` on ``x`` under ``record()``, backward from the cotangent
    drawn from ``seed`` at the output's shape."""
    xs = tmx.nd.array(x, ctx=CPU)
    xs.attach_grad()
    with tmx.autograd.record():
        out = block(xs)
        cot = _cotangent(seed, out.shape)
        (out * tmx.nd.array(cot, ctx=CPU)).sum().backward()
    grads = {k: p.grad().asnumpy() for k, p in
             block.collect_params().items() if p.grad_req != "null"}
    return out.asnumpy(), xs.grad.asnumpy(), grads


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_reference(case):
    c = _reference_all()[case]
    jparams = c["jblock"].collect_params()
    tparams = c["tblock"].collect_params()
    assert list(tparams.keys()) == list(jparams.keys())
    for k in jparams:
        assert tparams[k].grad_req == jparams[k].grad_req, k
        assert tuple(tparams[k].shape) == c["weights"][k].shape, k
    got, got_dx, got_g = _run(c["tblock"], c["x"], c["seed"])
    np.testing.assert_allclose(got, c["want"], err_msg="output", **TOL)
    np.testing.assert_allclose(got_dx, c["want_dx"], err_msg="input grad",
                               **TOL)
    assert sorted(got_g) == sorted(c["want_g"])
    for k, want in c["want_g"].items():
        np.testing.assert_allclose(got_g[k], want, err_msg=k, **TOL)


@pytest.mark.parametrize("cls,kw", [
    ("Conv1D", dict(channels=2, kernel_size=3, layout="NWC")),
    ("Conv3D", dict(channels=2, kernel_size=3, layout="NDHWC")),
    ("Conv2DTranspose", dict(channels=2, kernel_size=3, layout="NHWC")),
])
def test_channel_last_layouts_refused(cls, kw):
    """As ``Conv2D`` refuses NHWC: channel-last is ROADMAP A5d."""
    with context.device_scope("cpu"), pytest.raises(ValueError,
                                                    match="layout|are N"):
        getattr(tnn, cls)(**kw)


def test_transposed_weight_is_in_out_per_group():
    """A transposed convolution's weight is (in, out / groups, k...),
    deferred from the first input, on the device it was asked for.  With
    groups the reference convolves that weight as it is, so it runs only
    where the output width equals the input's and raises elsewhere
    (ROADMAP Queue C); so does the port."""
    blk = tnn.Conv2DTranspose(6, 3, strides=2, device="cpu")
    blk.initialize()
    out = blk(tmx.nd.array(np.zeros((1, 9, 4, 4), np.float32), ctx=CPU))
    assert tuple(blk.weight.shape) == (9, 6, 3, 3)
    assert out.shape == (1, 6, 9, 9)
    assert blk.weight.device == torch.device("cpu")
    for m, ctx in ((jmx, {}), (tmx, {"ctx": CPU})):
        with context.device_scope("cpu"):
            grouped = m.gluon.nn.Conv2DTranspose(6, 3, groups=3)
        grouped.initialize()
        with pytest.raises(ValueError):
            grouped(m.nd.array(np.zeros((1, 9, 4, 4), np.float32), **ctx))


def test_namespace_equals_reference():
    """``gluon.nn.__all__`` is the reference's, in its order."""
    assert tnn.__all__ == jnn.__all__
    for name in jnn.__all__:
        assert getattr(tnn, name).__name__ == name
