"""The port stands alone: importing it brings in neither ``jax`` nor the
JAX package, and its entry points refuse to run on the CPU unless asked.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import context, initializer
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.parallel import train_step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import incubator_mxnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
new = ["gluon.data.sampler", "gluon.data.dataset", "gluon.data.dataloader",
       "gluon.data.vision.datasets", "gluon.data.vision.transforms",
       "gluon.contrib.data", "gluon.contrib.estimator.estimator",
       "gluon.contrib.estimator.event_handler",
       "gluon.contrib.estimator.batch_processor", "gluon.contrib.nn",
       "gluon.contrib.rnn", "gluon.contrib.cnn", "ops.contrib_tail",
       "contrib.amp", "contrib.amp.amp", "contrib.amp.loss_scaler",
       "contrib.amp.lists", "contrib.amp.lists.symbol_bf16", "ops.npi",
       "numpy", "numpy._impl", "numpy.linalg", "numpy.random",
       "numpy_extension", "util", "ops.parity_tail", "operator"]
missing = [n for n in new if pkg.__name__ + "." + n not in names]
assert not missing, missing
for name, path in (("train_lm_torch", "example/long_context/train_lm_torch.py"),
                   ("train_imagenet_torch",
                    "example/image_classification/train_imagenet_torch.py"),
                   ("image_classification_torch",
                    "example/gluon/image_classification_torch.py"),
                   ("train_mnist_torch",
                    "example/image_classification/train_mnist_torch.py"),
                   ("word_lm_train_torch", "example/rnn/word_lm/train_torch.py"),
                   ("ssd_train_torch", "example/ssd/train_torch.py"),
                   ("cifar10_dist_torch",
                    "example/distributed_training/cifar10_dist_torch.py"),
                   ("bn_kernel_bench_torch", "tools/bn_kernel_bench_torch.py"),
                   ("launch_torch", "tools/launch_torch.py"),
                   ("supervise_torch", "tools/supervise_torch.py"),
                   ("serve_bench_torch", "tools/serve_bench_torch.py"),
                   ("flywheel_torch", "tools/flywheel_torch.py"),
                   ("compile_cache_torch", "tools/compile_cache_torch.py"),
                   ("int8_profile_torch", "tools/int8_profile_torch.py"),
                   ("resnet_np", "example/numpy/resnet_np.py"),
                   ("np_surface_cases", "tools/np_surface_cases.py")):
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from incubator_mxnet_tpu_torch import rtc
assert not rtc._libs, "rtc loaded a library at import"
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "incubator_mxnet_tpu" or k.startswith("incubator_mxnet_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30
    assert bad == "[]"


def _example_lm():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_train_lm_torch",
        os.path.join(ROOT, "example", "long_context", "train_lm_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LongContextLM


def _example_mnist():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_train_mnist_torch", os.path.join(
            ROOT, "example", "image_classification", "train_mnist_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_word_lm():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_word_lm_train_torch", os.path.join(
            ROOT, "example", "rnn", "word_lm", "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_ssd():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_ssd_train_torch",
        os.path.join(ROOT, "example", "ssd", "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bucketing_bind():
    from incubator_mxnet_tpu_torch import mod, symbol

    def sym_gen(key):
        return symbol.FullyConnected(symbol.var("data"), num_hidden=2), \
            ("data",), ()

    m = mod.BucketingModule(sym_gen, default_bucket_key=3)
    m.bind(data_shapes=[("data", (2, 3))])


def _fc():
    from incubator_mxnet_tpu_torch import symbol

    return symbol.FullyConnected(symbol.var("data"), num_hidden=2)


def _serve():
    from incubator_mxnet_tpu_torch import serve

    return serve


def _flywheel_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "flywheel_torch", os.path.join(ROOT, "tools", "flywheel_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _calibrate_on_default_device():
    """``quantize_model``'s calibration binds on ``ctx`` (None: the
    card)."""
    from incubator_mxnet_tpu_torch import nd, symbol
    from incubator_mxnet_tpu_torch.contrib import quantization

    cpu = context.cpu()
    args = {"fullyconnected0_weight": nd.ones((2, 3), ctx=cpu),
            "fullyconnected0_bias": nd.zeros((2,), ctx=cpu)}
    with __import__("incubator_mxnet_tpu_torch").name.NameManager():
        fc = symbol.FullyConnected(symbol.var("data"), num_hidden=2)
    quantization.quantize_model(fc, args, {}, calib_mode="naive",
                                calib_data=[[nd.ones((2, 3), ctx=cpu)]])


def _serve_on_cpu_when_asked():
    """The engine and the decoder run on the CPU when asked, with no card."""
    serve = _serve()
    net = tnn.Dense(4, in_units=3, device="cpu")
    initializer.initialize(net, generator=torch.Generator().manual_seed(0))
    eng = serve.ServeEngine(net, buckets=(2,), device="cpu")
    eng.warmup(np.zeros(3, np.float32))
    out = eng.infer(np.ones((3, 3), np.float32))
    e8 = serve.ServeEngine(net, buckets=(2,), dtype="int8", device="cpu")
    e8.warmup(np.zeros(3, np.float32))
    assert e8.infer(np.ones((3, 3), np.float32)).device.type == "cpu"
    lm = serve.TinyDecoderLM(vocab=8, d_model=4, n_heads=2, n_layers=1,
                             d_ff=8, max_len=8)
    dec = serve.CachedDecoder(lm, lm.init(0, device="cpu"),
                              seq_buckets=(8,), device="cpu")
    dec.start(np.array([[1, 2]]), max_new=2)
    return out, dec.step(np.array([3]))


def test_serving_runs_on_cpu_when_asked(monkeypatch):
    _no_card(monkeypatch)
    out, logits = _serve_on_cpu_when_asked()
    assert out.device.type == "cpu" and out.shape == (3, 4)
    assert logits.device.type == "cpu" and torch.isfinite(logits).all()


def _gdata():
    from incubator_mxnet_tpu_torch.gluon import data

    return data


def _gcontrib():
    from incubator_mxnet_tpu_torch.gluon import contrib

    return contrib


def _estimator():
    return _gcontrib().estimator


def test_data_pipeline_and_estimator_run_on_cpu_when_asked(monkeypatch):
    """A ``DataLoader`` and an ``Estimator`` asked for the CPU build their
    samples and train there with no card."""
    _no_card(monkeypatch)
    rng = np.random.RandomState(0)
    ds = _gdata().ArrayDataset(rng.uniform(size=(8, 3)).astype(np.float32),
                               rng.randint(0, 2, 8).astype(np.float32))
    loader = _gdata().DataLoader(ds, batch_size=4, num_workers=2,
                                 device="cpu")
    net = tnn.Dense(2, in_units=3, device="cpu")
    est = _estimator().Estimator(net, tloss.SoftmaxCrossEntropyLoss(),
                                 context="cpu")
    est.fit(loader, epochs=1)
    assert net.weight.device.type == "cpu"
    assert all(b.context.type == "cpu" for batch in loader for b in batch)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", [
    lambda: context.default_device(),
    lambda: context.resolve("cuda"),
    lambda: tnn.Conv2D(4, 3, in_channels=3),
    lambda: tnn.Dense(4, in_units=3),
    lambda: tres.GhostBNReLU(group=2, in_channels=4),
    lambda: tres.resnet50_v1(ghost_bn=16),
    lambda: _example_lm()(64, 32, 2, 1),
    lambda: __import__("incubator_mxnet_tpu_torch").mod.Module(_fc()),
    lambda: _fc().simple_bind(None, data=(2, 3)),
    lambda: _example_mnist().main(["--num-epochs", "1", "--data-dir",
                                   "/nonexistent"]),
    lambda: _example_word_lm().main(["--epochs", "1"]),
    lambda: __import__("incubator_mxnet_tpu_torch").gluon.rnn.LSTM(4),
    lambda: __import__("incubator_mxnet_tpu_torch").gluon.rnn.GRUCell(4),
    lambda: tnn.Embedding(5, 3),
    lambda: __import__("incubator_mxnet_tpu_torch").rnn.BucketSentenceIter(
        [[1, 2, 3], [2, 3, 4]], 2, buckets=[3]),
    _bucketing_bind,
    lambda: _example_ssd().main(["--batches", "1"]),
    lambda: __import__("incubator_mxnet_tpu_torch").image.ImageDetIter(
        2, (3, 8, 8), imglist=[([0, 0.1, 0.1, 0.5, 0.5], "a.png")]),
    lambda: _serve().ServeEngine(tnn.Dense(4, in_units=3, device="cpu"),
                                 buckets=(2,)),
    lambda: _serve().CachedDecoder(_serve().TinyDecoderLM(max_len=8), {},
                                   seq_buckets=(8,)),
    lambda: _serve().TinyDecoderLM().init(0),
    lambda: _serve().init_cache(1, 1, 8, 2, 4),
    lambda: _serve().ServeEngine(tnn.Dense(4, in_units=3, device="cpu"),
                                 buckets=(2,), dtype="int8"),
    lambda: _flywheel_tool().main(["--steps", "2"]),
    _calibrate_on_default_device,
    lambda: _gdata().DataLoader(_gdata().ArrayDataset(np.ones((4, 2))),
                                batch_size=2),
    lambda: _estimator().Estimator(tnn.Dense(2, in_units=3, device="cpu"),
                                   tloss.L2Loss()),
    lambda: _gcontrib().cnn.DeformableConvolution(4),
    lambda: _gcontrib().rnn.LSTMPCell(8, 4),
    lambda: _gcontrib().rnn.Conv2DLSTMCell((3, 5, 5), 4, 3, 3),
    lambda: _gcontrib().nn.SyncBatchNorm(),
    lambda: tnn.Conv1D(4, 3),
    lambda: tnn.Conv3D(4, 3, in_channels=2),
    lambda: tnn.Conv1DTranspose(4, 3),
    lambda: tnn.Conv2DTranspose(4, 3, in_channels=2),
    lambda: tnn.Conv3DTranspose(4, 3),
    lambda: tnn.InstanceNorm(),
    lambda: tnn.LayerNorm(in_channels=8),
    lambda: tnn.GroupNorm(num_groups=2),
    lambda: tnn.PReLU(),
])
def test_entry_points_refuse_cpu_without_asking(monkeypatch, build):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_train_step_refuses_cpu_without_asking(monkeypatch):
    net = tnn.Dense(3, in_units=4, device="cpu")
    initializer.initialize(net, generator=torch.Generator().manual_seed(0))
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.make_train_step(net, tloss.SoftmaxCrossEntropyLoss(),
                              learning_rate=0.1)
    step = tstep.make_train_step(net, tloss.SoftmaxCrossEntropyLoss(),
                                 learning_rate=0.1, device="cpu")
    loss = step(torch.ones(2, 4), torch.tensor([0.0, 2.0]))
    assert loss.device.type == "cpu" and torch.isfinite(loss)


def test_step_refuses_net_on_other_device():
    net = tnn.Dense(3, in_units=4, device="cpu")
    net.weight = torch.nn.Parameter(torch.empty(3, 4, device="meta"))
    with pytest.raises(ValueError, match="weight is on meta"):
        tstep.TrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                        tstep.FunctionalOptimizer(), device="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        context.resolve("meta")


@pytest.mark.parametrize("build", [
    lambda mx: mx.nd.array([1.0, 2.0]),
    lambda mx: mx.nd.zeros((2, 3)),
    lambda mx: mx.nd.ones(3),
    lambda mx: mx.nd.arange(4),
    lambda mx: mx.nd.random.normal(shape=(2,)),
    lambda mx: mx.nd.random.uniform(shape=(2,)),
    lambda mx: mx.nd.broadcast_add(np.ones(2), np.ones(2)),
    lambda mx: mx.rtc.CudaModule(mx.rtc.user_source("scale_kernel"),
                                 exports=["scale_kernel"]),
    lambda mx: mx.rtc.CudaKernel(None, "scale_kernel", mx.rtc.parse_signature(
        mx.rtc.USER_KERNELS["scale_kernel"])).launch(
            [mx.nd.zeros((2,), ctx=mx.cpu())] * 2 + [2], mx.cpu(),
            (1, 1, 1), (2, 1, 1)),
])
def test_imperative_entry_points_refuse_cpu_without_asking(monkeypatch,
                                                          build):
    import incubator_mxnet_tpu_torch as mx

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(mx)


@pytest.mark.parametrize("build", [
    lambda mx: mx.np.array([1.0, 2.0]),
    lambda mx: mx.np.zeros((2, 3)),
    lambda mx: mx.np.ones(3),
    lambda mx: mx.np.full((2,), 1.5),
    lambda mx: mx.np.arange(4),
    lambda mx: mx.np.eye(3),
    lambda mx: mx.np.indices((2, 3)),
    lambda mx: mx.np.tril_indices(3),
    lambda mx: mx.np.add(np.ones(2), 1.0),
    lambda mx: mx.np.random.uniform(size=2),
    lambda mx: mx.np.random.normal(size=2),
    lambda mx: mx.np.random.randint(4, size=2),
    lambda mx: mx.np.random.gamma(2.0, size=2),
    lambda mx: mx.np.random.choice(5, size=2),
    lambda mx: mx.np.random.multinomial(3, [0.5, 0.5]),
    lambda mx: mx.nd.random_gamma(shape=(2,)),
    lambda mx: mx.nd.random_poisson(shape=(2,)),
    lambda mx: mx.nd.random_exponential(shape=(2,)),
    lambda mx: mx.nd.random_negative_binomial(shape=(2,)),
    lambda mx: mx.nd.random_generalized_negative_binomial(shape=(2,)),
    lambda mx: mx.nd._npi_normal_n(size=(2,)),
    lambda mx: mx.nd._npi_uniform_n(size=(2,)),
    lambda mx: mx.nd._npi_choice(a=3, size=(2,)),
    lambda mx: mx.nd._npi_hanning(M=4),
    lambda mx: mx.nd._npi_logspace(num=3),
    lambda mx: mx.nd._npi_indices(dimensions=(2,)),
])
def test_numpy_frontend_refuses_cpu_without_asking(monkeypatch, build):
    """``mx.np``'s constructors, functions given no array, ``np.random``
    and the samplers build on the card, and raise without one."""
    import incubator_mxnet_tpu_torch as mx

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(mx)


@pytest.mark.parametrize("build", [
    lambda mx: mx.nd._zeros_without_dtype(shape=(2,)),
    lambda mx: mx.nd._sample_unique_zipfian(range_max=10, shape=(2,)),
    lambda mx: mx.nd.Custom(np.ones(2, np.float32), op_type="_iso_sqr"),
    lambda mx: mx.nd.Custom(op_type="_iso_const"),
    lambda mx: mx.nd.multi_sum_sq(np.ones(2, np.float32), num_arrays=1),
])
def test_op_tail_and_custom_refuse_cpu_without_asking(monkeypatch, build):
    """The ops of ``ops/parity_tail.py`` given no array, and ``Custom`` fed
    host data or no input at all, build on the card and raise without
    one."""
    import incubator_mxnet_tpu_torch as mx

    _iso_sqr(mx)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(mx)


def _iso_sqr(mx):
    class Sqr(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

    @mx.operator.register("_iso_sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Const(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], out_data[0] + 2.0)

    @mx.operator.register("_iso_const")
    class ConstProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return []

        def infer_shape(self, in_shape):
            return [], [[2]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Const()


def test_op_tail_and_custom_run_on_cpu_when_asked(monkeypatch):
    """With ``ctx=mx.cpu()`` (or CPU arrays) the same calls run on the CPU
    with no card, and ``Custom``'s callbacks get CPU arrays."""
    import incubator_mxnet_tpu_torch as mx

    _iso_sqr(mx)
    _no_card(monkeypatch)
    cpu = mx.cpu()
    assert mx.nd._zeros_without_dtype(shape=(2,), ctx=cpu).context == cpu
    cand, _ = mx.nd._sample_unique_zipfian(range_max=10, shape=(2,), ctx=cpu)
    assert cand.context == cpu
    x = mx.nd.array(np.array([1.0, 3.0], np.float32), ctx=cpu)
    y = mx.nd.Custom(x, op_type="_iso_sqr")
    assert y.context == cpu and y.asnumpy().tolist() == [1.0, 9.0]
    assert mx.nd.multi_sum_sq(x, num_arrays=1)[0].context == cpu
    with context.device_scope("cpu"):
        z = mx.nd.Custom(op_type="_iso_const")
    assert z.context == cpu and z.asnumpy().tolist() == [2.0, 2.0]


def test_numpy_frontend_runs_on_cpu_when_asked(monkeypatch):
    import incubator_mxnet_tpu_torch as mx

    _no_card(monkeypatch)
    cpu = mx.cpu()
    a = mx.np.arange(6, ctx=cpu)
    assert mx.np.sum(a).context == cpu
    assert mx.np.random.uniform(size=3, ctx=cpu).context == cpu
    assert mx.nd.random_gamma(shape=(2,), ctx=cpu).context == cpu
    with context.device_scope("cpu"):
        assert mx.np.indices((2, 2)).context == cpu
        assert mx.np.zeros(3).context == cpu


def test_imperative_path_runs_on_cpu_when_asked(monkeypatch, tmp_path):
    """``ctx=mx.cpu()`` works everywhere but ``rtc``, which has no CPU
    path and says so."""
    import incubator_mxnet_tpu_torch as mx

    _no_card(monkeypatch)
    cpu = mx.cpu()
    mx.nd.random.seed(0)
    w = mx.nd.random.uniform(shape=(3, 3), ctx=cpu)
    w.attach_grad()
    x = mx.nd.array(np.ones((2, 3), np.float32), ctx=cpu)
    with mx.autograd.record():
        loss = mx.nd.dot(x, w).sum()
    loss.backward()
    assert w.grad.context == cpu and w.grad.asnumpy().shape == (3, 3)
    path = str(tmp_path / "w.params")
    mx.nd.save(path, {"w": w})
    assert mx.nd.load(path, ctx=cpu)["w"].context == cpu
    with pytest.raises(RuntimeError, match="CUDA"):
        mx.nd.load(path)
    assert mx.nd.zeros((1,), ctx=cpu).context == cpu
    with pytest.raises(RuntimeError, match="CUDA"):
        mx.rtc.launch_scale(mx.rtc.CudaKernel(
            None, "scale_kernel",
            mx.rtc.parse_signature(mx.rtc.USER_KERNELS["scale_kernel"])),
            x, cpu)


def test_flash_attention_runs_on_cpu_without_a_card(monkeypatch):
    """CPU tensors take the plain versions whether or not a card exists:
    nothing builds or launches a kernel."""
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import flash_attention

    _no_card(monkeypatch)
    before = _kernels.launch_counts()
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    out = flash_attention(q, q, q, causal=True)
    out.sum().backward()
    assert out.device.type == "cpu" and torch.isfinite(q.grad).all()
    assert _kernels.launch_counts() == before
