"""The port's initializers (``initializer.py``) against the JAX package's.

- Deterministic ones equal the reference bit for bit: ``Constant`` (a
  number, an array), ``Bilinear``, ``LSTMBias`` (called as a weight
  rule and as a parameter's ``__init__`` attribute), ``Zero``/``One``,
  ``Mixed``, ``Load`` (a dict, the reference's ``.params`` file, the
  default initializer) and the layout ``FusedRNN`` fills (each gate's
  slice of each layer's and direction's matrices, under the
  reference's names, and the forget-gate biases).
- Random ones are held by their law: ``Uniform`` and ``Xavier``
  (uniform: range and variance; gaussian: mean and variance; ``avg``/
  ``in``/``out`` fans), ``Normal``, ``MSRAPrelu``, and ``Orthogonal``
  (``q q^T = scale^2 I``, uniform and normal draws) to 1e-5, moments
  within 5 % over 32k draws; the same generator seed gives the same
  numbers.
- The registry creates every initializer by name; unknown arguments of
  ``Xavier`` are refused.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import initializer as jinit

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import initializer as tinit


def _ref(init, name, shape, attrs=None):
    arr = jmx.nd.zeros(shape)
    init(jinit.InitDesc(name, attrs or {}), arr)
    return arr.asnumpy()


def _port(init, name, shape, attrs=None, seed=0):
    t = torch.zeros(shape)
    init(tinit.InitDesc(name, attrs or {}), t,
         torch.Generator().manual_seed(seed))
    return t.numpy()


VALUE = np.arange(12, dtype=np.float32).reshape(3, 4) / 7


@pytest.mark.parametrize("make,name,shape", [
    (lambda m: m.Constant(0.25), "fc_weight", (3, 4)),
    (lambda m: m.Constant(VALUE), "fc_weight", (3, 4)),
    (lambda m: m.Constant(0.25), "fc_bias", (4,)),
    (lambda m: m.Bilinear(), "up_weight", (2, 3, 4, 4)),
    (lambda m: m.Bilinear(), "up_weight", (1, 2, 3, 5)),
    (lambda m: m.LSTMBias(0.5), "lstm_i2h_weight", (16,)),
    (lambda m: m.LSTMBias(0.5), "lstm_i2h_bias", (16,)),
    (lambda m: m.One(), "x_gamma", (5,)),
    (lambda m: m.Zero(), "x_weight", (5, 2)),
    (lambda m: m.Mixed([".*bias", ".*fc.*", ".*"],
                       [m.One(), m.Constant(3.0), m.Constant(-1.0)]),
     "fc_weight", (2, 3)),
    (lambda m: m.Mixed([".*bias", ".*"], [m.One(), m.Constant(3.0)]),
     "conv_bias", (4,)),
])
def test_deterministic_initializers_bit_for_bit(make, name, shape):
    got = _port(make(tinit), name, shape)
    want = _ref(make(jinit), name, shape)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_lstm_bias_as_init_attribute():
    attrs = {"__init__": "lstmbias"}
    want = _ref(jinit.Uniform(), "l_bias", (8,), attrs)
    assert np.array_equal(_port(tinit.Uniform(), "l_bias", (8,), attrs),
                          want)
    assert want[2:4].tolist() == [1.0, 1.0] and not want[:2].any()
    with pytest.raises(ValueError, match="did not match"):
        _port(tinit.Mixed(["a.*"], [tinit.One()]), "b_weight", (2,))


def test_load_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    w, b = rng.rand(3, 2).astype(np.float32), rng.rand(3).astype(np.float32)
    path = str(tmp_path / "p.params")
    jmx.nd.save(path, {"arg:fc_weight": jmx.nd.array(w),
                       "aux:fc_bias": jmx.nd.array(b)})
    for src in (path, {"fc_weight": tmx.nd.array(w, ctx=tmx.cpu()),
                       "fc_bias": b}):
        load = tinit.Load(src, default_init=tinit.Constant(7.0))
        assert np.array_equal(_port(load, "fc_weight", (3, 2)), w)
        assert np.array_equal(_port(load, "fc_bias", (3,)), b)
        assert np.array_equal(
            _port(load, "other_weight", (2,)),
            _ref(jinit.Load(path, default_init=jinit.Constant(7.0)),
                 "other_weight", (2,)))
    with pytest.raises(ValueError, match="target"):
        _port(tinit.Load(path), "fc_weight", (2, 3))
    with pytest.raises(ValueError, match="no default"):
        _port(tinit.Load(path), "other_weight", (2,))


@pytest.mark.parametrize("mode,layers,bidirectional", [
    ("lstm", 2, True), ("gru", 1, False), ("rnn_tanh", 2, False)])
def test_fused_rnn_layout_matches_reference(mode, layers, bidirectional):
    """Each gate slice, layer and direction gets the value its
    reference name selects; biases 0 but LSTM's forget gates."""
    h, c = 3, 5
    size = tmx.ops.rnn.rnn_param_size(layers, c, h, mode, bidirectional)

    def make(m):
        inner = m.Mixed(
            ["l0_i2h_i_weight", ".*_f_weight", ".*_z_weight", "r.*_h2h.*",
             "l1.*", ".*"],
            [m.Constant(1.0), m.Constant(2.0), m.Constant(6.0),
             m.Constant(3.0), m.Constant(4.0), m.Constant(5.0)])
        return m.FusedRNN(inner, h, layers, mode, bidirectional,
                          forget_bias=0.75)

    got = _port(make(tinit), "lstm_parameters", (size,))
    want = _ref(make(jinit), "lstm_parameters", (size,))
    assert np.array_equal(got, want)
    assert len(set(got.tolist())) >= 3


def _moments(init, shape, name="fc_weight", seed=0):
    x = _port(init, name, shape, seed=seed).astype(np.float64)
    return x, x.mean(), x.var()


@pytest.mark.parametrize("kw,var", [
    (dict(), 3.0 / 288 / 3),                     # uniform, avg fans
    (dict(factor_type="in"), 3.0 / 64 / 3),
    (dict(factor_type="out", magnitude=2), 2.0 / 512 / 3),
    (dict(rnd_type="gaussian"), 3.0 / 288),
    (dict(rnd_type="gaussian", factor_type="in", magnitude=2), 2.0 / 64),
])
def test_xavier_law(kw, var):
    shape = (512, 64)
    x, mean, v = _moments(tinit.Xavier(**kw), shape)
    assert abs(mean) < 0.05 * np.sqrt(var)
    assert abs(v / var - 1) < 0.05
    if kw.get("rnd_type", "uniform") == "uniform":
        assert np.abs(x).max() <= np.sqrt(3 * var) * (1 + 1e-6)
    ref = _ref(jinit.Xavier(**kw), "fc_weight", shape).astype(np.float64)
    assert abs(ref.var() / var - 1) < 0.05
    assert np.array_equal(x, _moments(tinit.Xavier(**kw), shape)[0])


@pytest.mark.parametrize("init,var", [
    (tinit.Uniform(0.2), 0.04 / 3),
    (tinit.Normal(0.3), 0.09),
    (tinit.MSRAPrelu(factor_type="in", slope=0.5), 2 / 1.25 / 64),
])
def test_uniform_normal_msra_law(init, var):
    _, mean, v = _moments(init, (512, 64))
    assert abs(mean) < 0.05 * np.sqrt(var)
    assert abs(v / var - 1) < 0.05


@pytest.mark.parametrize("shape", [(8, 24), (24, 8), (6, 2, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal(shape, rand_type):
    scale = 1.5
    x = _port(tinit.Orthogonal(scale, rand_type), "w_weight", shape)
    q = x.reshape(shape[0], -1).astype(np.float64)
    gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
    assert np.abs(gram - scale ** 2 * np.eye(len(gram))).max() < 1e-5
    ref = _ref(jinit.Orthogonal(scale, rand_type), "w_weight", shape)
    rq = ref.reshape(shape[0], -1).astype(np.float64)
    rgram = rq @ rq.T if rq.shape[0] <= rq.shape[1] else rq.T @ rq
    assert np.abs(rgram - scale ** 2 * np.eye(len(rgram))).max() < 1e-5


def test_registry_and_refusals():
    for name in ("zeros", "ones", "constant", "uniform", "normal",
                 "orthogonal", "xavier", "msraprelu", "bilinear",
                 "lstmbias"):
        assert isinstance(tinit.registry_create(name), tinit.Initializer)
    fused = tinit.registry_create("fusedrnn", init="xavier", num_hidden=2,
                                  num_layers=1, mode="gru")
    assert isinstance(fused._init, tinit.Xavier)
    with pytest.raises(ValueError, match="rnd_type"):
        tinit.Xavier(rnd_type="laplace")
    with pytest.raises(ValueError, match="factor_type"):
        tinit.Xavier(factor_type="sum")
