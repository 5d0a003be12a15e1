"""The port's ``dist_async`` store and its parameter host
(``incubator_mxnet_tpu_torch/kvstore/async_host.py``,
``kvstore/dist.py``) and ``KVStore.set_gradient_compression``, against
the JAX package's (``tests/test_kvstore.py``, ``tests/async_worker.py``),
on the CPU.

- The host over loopback: ``INIT`` (the first writer wins), ``PUSH``
  (summed without an optimizer, the optimizer's update with one, shipped
  pickled by ``SET_OPT``: equal bit for bit to the same optimizer run in
  this process), ``PULL``, ``CMD`` to a controller; f32 only (f16, f64,
  bf16 and int32 refused), oversized frames refused at the sender.
- ``dist_async`` over 2 gloo ranks (``tests/torch_dist_worker.py async``)
  taking 20 and 35 steps: each rank's final weight solves the shared
  regression (within 0.1, the reference's bound).
- ``set_gradient_compression({"type": "2bit", "threshold": 0.5})``: the
  pulled values of a ``local`` and a ``dist_sync`` store after 4 pushes
  equal the reference store's bit for bit (the residual carries).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import kv as tkv
from incubator_mxnet_tpu_torch.kvstore.async_host import (AsyncParamClient,
                                                          AsyncParamHost,
                                                          _MAX_MSG, _send)

import torch_dist_launch


@pytest.fixture
def host():
    h = AsyncParamHost(0)
    c = AsyncParamClient("127.0.0.1", h.port)
    yield h, c
    c.close()
    h.stop()


def test_async_host_loopback(host):
    h, c = host
    c.init("w", np.ones(4, np.float32))
    c.init("w", np.full(4, 9.0, np.float32))  # the first writer wins
    c.push("w", np.full(4, 0.5, np.float32))
    np.testing.assert_array_equal(c.pull("w"), np.full(4, 1.5, np.float32))
    c.push("w", torch.full((4,), 0.25))  # an f32 tensor is accepted
    np.testing.assert_array_equal(c.pull("w"), np.full(4, 1.75, np.float32))
    with pytest.raises(RuntimeError, match="not been initialized"):
        c.pull("nope")
    seen = []
    h.set_controller(lambda head, body: seen.append((head, body)))
    c.send_command(3, "hello")
    assert seen == [(3, "hello")]
    with pytest.raises(RuntimeError, match="profiler"):
        c.send_command(5, "11")


def test_async_host_rejects_non_f32_and_bounds_messages(host):
    _, c = host
    c.init("w", np.ones(4, np.float32))
    for bad in (np.ones(4, np.float16), np.ones(4, np.float64),
                torch.ones(4, dtype=torch.bfloat16)):
        with pytest.raises(TypeError, match="float32 only"):
            c.push("w", bad)
    with pytest.raises(TypeError, match="float32 only"):
        c.init("v", np.ones(2, np.int32))
    with pytest.raises(ValueError):
        _send(c._sock, b"x" * (_MAX_MSG + 1))
    np.testing.assert_array_equal(c.pull("w"), np.ones(4, np.float32))


def test_async_host_server_optimizer(host):
    """``SET_OPT`` ships the pickled optimizer; each push is one update on
    the host, equal bit for bit to the same updates run here."""
    _, c = host
    w0 = np.linspace(-1, 1, 6).astype(np.float32)
    c.init("3", w0)
    opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3)
    c.set_optimizer(opt)
    rng = np.random.RandomState(0)
    grads = [rng.randn(6).astype(np.float32) for _ in range(3)]
    for g in grads:
        c.push("3", g)
    local = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3)
    w = tmx.nd.array(w0, ctx=tmx.cpu())
    st = local.create_state_multi_precision(3, w)
    for g in grads:
        local.update_multi_precision(3, w, tmx.nd.array(g, ctx=tmx.cpu()), st)
    assert c.pull("3").tobytes() == w.asnumpy().tobytes()


def test_dist_async_unequal_steps(tmp_path):
    proc = torch_dist_launch.start("async", tmp_path)
    ranks = torch_dist_launch.finish(proc, tmp_path, timeout=180)
    assert [int(r["steps"]) for r in ranks] == [20, 35]
    for r in ranks:
        assert int(r["nw"]) == 2
        np.testing.assert_allclose(r["w"], r["w_true"], atol=0.1)


@pytest.mark.parametrize("kind", ["local", "dist_sync"])
def test_gradient_compression_2bit_matches_reference(kind):
    params = {"type": "2bit", "threshold": 0.5}
    ref = jmx.kv.create(kind)
    ref.set_gradient_compression(params)
    with pytest.warns(UserWarning) if kind != "local" else _nothing():
        port = tkv.create(kind)
    port.set_gradient_compression(params)
    assert port._compression_params == params
    rng = np.random.RandomState(1)
    shape = (5, 7)
    ref.init("g", jmx.nd.zeros(shape))
    port.init("g", tmx.nd.zeros(shape, ctx=tmx.cpu()))
    jout = jmx.nd.zeros(shape)
    tout = tmx.nd.zeros(shape, ctx=tmx.cpu())
    for _ in range(4):
        g = (rng.randn(*shape) * 0.4).astype(np.float32)
        ref.push("g", jmx.nd.array(g))
        port.push("g", tmx.nd.array(g, ctx=tmx.cpu()))
        ref.pull("g", out=jout)
        port.pull("g", out=tout)
        assert tout.asnumpy().tobytes() == jout.asnumpy().tobytes()
    assert set(np.unique(tout.asnumpy())) <= {-0.5, 0.0, 0.5}
    res_j = ref._compressor.state_dict()["g"]
    res_t = port._compressor.state_dict()["g"]
    assert np.asarray(res_j).tobytes() == res_t.numpy().tobytes()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
