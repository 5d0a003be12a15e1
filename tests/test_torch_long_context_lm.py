"""The port's long-context LM (``example/long_context/train_lm_torch.py``)
against the JAX example (``example/long_context/train_lm.py``), on the CPU.

Both example files are loaded by path.  The weights come from the JAX
example's own ``build_params(np.random.RandomState(0), vocab=64, dim=32,
n_layers=2)`` and are carried into the port by key
(``convert.lm_params_from_jax``).  The JAX side is the example's forward
and loss (``train_lm.py:80-107``) with ``sharded_self_attention`` on a
one-device ``sp`` mesh, ``impl="ulysses"``: its flash attention runs the
Pallas kernels in interpret mode.  The port's side runs the plain
versions of its kernels (CPU tensors).  Seq 32, heads 2 (head dim 16),
batch 2, f32.

Tolerances (f32; the two sides round the same arithmetic in another
order): logits 1e-5 absolute, loss 1e-6 relative, gradients rtol 1e-4 /
atol 1e-6, parameters after 3 steps of the example's update (lr 0.05,
momentum 0.9) 1e-5 absolute.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.parallel import make_mesh
from incubator_mxnet_tpu.parallel.ring_attention import \
    sharded_self_attention

from incubator_mxnet_tpu_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, DIM, LAYERS, HEADS, SEQ, BATCH = 64, 32, 2, 2, 32, 2


def _load(name):
    path = os.path.join(ROOT, "example", "long_context", name + ".py")
    spec = importlib.util.spec_from_file_location("_example_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jex = _load("train_lm")
tex = _load("train_lm_torch")


def _jax_loss_fn():
    """train_lm.py's forward and loss_fn, on a one-device sp mesh."""
    mesh = make_mesh({"sp": 1}, devices=jax.devices()[:1])
    H, D = HEADS, DIM // HEADS

    def ln(x, g, b):
        m = x.mean(-1, keepdims=True)
        v = ((x - m) ** 2).mean(-1, keepdims=True)
        return (x - m) * jax.lax.rsqrt(v + 1e-5) * g + b

    def forward(params, tokens):
        x = params["embed"][tokens]
        B, S, dim = x.shape
        for li in range(LAYERS):
            p = params["l%d" % li]
            h = ln(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(B, S, H, D).transpose(0, 2, 1, 3)
            k = (h @ p["wk"]).reshape(B, S, H, D).transpose(0, 2, 1, 3)
            v = (h @ p["wv"]).reshape(B, S, H, D).transpose(0, 2, 1, 3)
            att = sharded_self_attention(q, k, v, mesh, seq_axis="sp",
                                         causal=True, impl="ulysses")
            att = att.transpose(0, 2, 1, 3).reshape(B, S, dim)
            x = x + att @ p["wo"]
            h = ln(x, p["ln2_g"], p["ln2_b"])
            x = x + jax.nn.gelu(h @ p["w1"]) @ p["w2"]
        return x @ params["out"]

    def loss_fn(params, tokens):
        logits = forward(params, tokens[:, :-1])
        tgt = tokens[:, 1:]
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(lp, tgt[..., None], -1).mean()

    return forward, loss_fn


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    params = jex.build_params(rng, VOCAB, DIM, LAYERS)
    tokens = tex.synthetic_tokens(rng, VOCAB, BATCH, SEQ)
    lm = tex.LongContextLM(VOCAB, DIM, HEADS, LAYERS, device="cpu")
    convert.lm_params_from_jax(lm, params)
    return params, tokens, lm


def test_build_params_draws_match_jax_example():
    a = _flat(jex.build_params(np.random.RandomState(0), VOCAB, DIM, LAYERS))
    b = _flat(tex.build_params(np.random.RandomState(0), VOCAB, DIM, LAYERS))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_carried_by_key(pair):
    params, _, lm = pair
    got = _flat(convert.lm_params_to_numpy(lm))
    want = _flat(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad = dict(params)
    bad["l0"] = dict(params["l0"], wq=np.zeros((DIM, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="l0.wq has shape"):
        convert.lm_params_from_jax(lm, bad)
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_jax(lm, {k: v for k, v in params.items()
                                        if k != "out"})


def test_logits_loss_and_grads_match_jax(pair):
    params, tokens, lm = pair
    forward, loss_fn = _jax_loss_fn()
    jtok = jnp.asarray(tokens)
    jlogits = forward(params, jtok[:, :-1])
    jloss, jgrads = jax.value_and_grad(loss_fn)(params, jtok)

    ttok = torch.from_numpy(tokens)
    with torch.no_grad():
        logits = lm(ttok[:, :-1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    names = [n for n, _ in lm.named_parameters()]
    loss = tex.loss_fn(lm, ttok)
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = _flat(jgrads)
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_three_steps_match_jax(pair):
    params, tokens, _ = pair
    lm = tex.LongContextLM(VOCAB, DIM, HEADS, LAYERS, device="cpu")
    convert.lm_params_from_jax(lm, params)
    _, loss_fn = _jax_loss_fn()

    @jax.jit
    def jstep(params, opt_m, tokens, lr):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
        opt_m = jax.tree.map(lambda m, g: 0.9 * m + g, opt_m, grads)
        params = jax.tree.map(lambda p, m: p - lr * m, params, opt_m)
        return params, opt_m, loss

    jparams, opt_m = params, jax.tree.map(jnp.zeros_like, params)
    step = tex.make_step(lm, 0.05)
    ttok = torch.from_numpy(tokens)
    for _ in range(3):
        jparams, opt_m, jloss = jstep(jparams, opt_m, jnp.asarray(tokens),
                                      0.05)
        loss = step(ttok)
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = _flat(convert.lm_params_to_numpy(lm))
    for k, want in _flat(jparams).items():
        assert want.dtype == np.float32
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5,
                                   err_msg=k)
