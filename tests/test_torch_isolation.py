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
                   ("supervise_torch", "tools/supervise_torch.py")):
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
