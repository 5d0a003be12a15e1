"""The port stands alone: importing it brings in neither ``jax`` nor the
JAX package, and its entry points refuse to run on the CPU unless asked.
"""
import os
import subprocess
import sys

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
spec = importlib.util.spec_from_file_location(
    "train_lm_torch", "example/long_context/train_lm_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
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
    assert int(n) >= 17
    assert bad == "[]"


def _example_lm():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_train_lm_torch",
        os.path.join(ROOT, "example", "long_context", "train_lm_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LongContextLM


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
