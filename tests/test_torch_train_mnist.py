"""``example/image_classification/train_mnist_torch.py`` against the
JAX package's ``train_mnist.py``.

- The example's symbols: ``lenet_symbol()`` and ``mlp_symbol()`` give
  the reference's JSON byte for byte, each package loads the other's
  file, and the synthetic data is the reference's arrays.
- Three ``Module`` steps of each net (the example's sgd, lr 0.1,
  momentum 0.9, ``rescale_grad`` 1 / batch, batch 16 of its synthetic
  data) from the reference's ``Uniform(0.01)`` parameters copied by
  name, against the reference's module: outputs, every parameter and
  every momentum within 1e-5 of the array's largest magnitude after
  step 1 and within 1e-4 after step 3 (measured on a CPU: at most
  7.1e-7 after step 1 and 6.0e-7 after step 3 for LeNet, 5.1e-7 and
  4.0e-7 for the MLP).
- ``main(["--device", "cpu", ...])`` trains an epoch of each net with
  finite losses.
"""
import importlib.util
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "example", "image_classification", rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JEX = _load("_train_mnist", "train_mnist.py")
TEX = _load("_train_mnist_torch", "train_mnist_torch.py")
NETS = ["lenet", "mlp"]


@pytest.mark.parametrize("net", NETS)
def test_symbols_and_data_match_reference(net, tmp_path):
    with jmx.name.NameManager():
        js = getattr(JEX, net + "_symbol")()
    with tmx.name.NameManager():
        ts = getattr(TEX, net + "_symbol")()
    assert ts.tojson() == js.tojson()
    js.save(str(tmp_path / "j.json"))
    ts.save(str(tmp_path / "t.json"))
    assert tmx.sym.load(str(tmp_path / "j.json")).tojson() == js.tojson()
    assert jmx.sym.load(str(tmp_path / "t.json")).tojson() == js.tojson()
    args = TEX.parse_args(["--network", net, "--data-dir", "/nonexistent"])
    jtrain, jval = JEX.get_iters(args, flat=net == "mlp")
    ttrain, tval = TEX.get_iters(args, CPU)
    for j, t in ((jtrain, ttrain), (jval, tval)):
        for (jn, jx), (tn, tx) in zip(j.data + j.label, t.data + t.label):
            assert jn == tn
            np.testing.assert_array_equal(tx, jx)


def _momentum(mod, i):
    return mod._updater.states[i].asnumpy()


@pytest.mark.parametrize("net", NETS)
def test_three_module_steps_match_reference(net):
    args = TEX.parse_args(["--network", net, "--batch-size", "16"])
    with jmx.name.NameManager():
        jsym = getattr(JEX, net + "_symbol")()
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    tmod = TEX.build_module(args, CPU)
    shape = (16, 784) if net == "mlp" else (16, 1, 28, 28)
    for mod in (jmod, tmod):
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (16,))])
    jmod.init_params(initializer=jmx.init.Uniform(0.01))
    arg, aux = jmod.get_params()
    tmod.init_params(arg_params={k: tmx.nd.array(v.asnumpy(), ctx=CPU)
                                 for k, v in arg.items()})
    opt = {"learning_rate": args.lr, "momentum": 0.9}
    jmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    rng = np.random.RandomState(0)
    x = rng.rand(3, *shape).astype(np.float32)
    y = rng.randint(0, 10, (3, 16)).astype(np.float32)
    names = tmod._param_names
    for step in range(3):
        jmod.forward_backward(jmx.io.DataBatch([jmx.nd.array(x[step])],
                                               [jmx.nd.array(y[step])]))
        tmod.forward_backward(tmx.io.DataBatch(
            [tmx.nd.array(x[step], ctx=CPU)], [tmx.nd.array(y[step],
                                                            ctx=CPU)]))
        jmod.update()
        tmod.update()
        tol = 1e-5 if step == 0 else 1e-4
        pairs = [(tmod.get_outputs()[0].asnumpy(),
                  jmod.get_outputs()[0].asnumpy())]
        pairs += [(tmod.get_params()[0][n].asnumpy(),
                   jmod.get_params()[0][n].asnumpy()) for n in names]
        pairs += [(_momentum(tmod, i), _momentum(jmod, i))
                  for i in range(len(names))]
        for got, want in pairs:
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= tol, (step, err)


@pytest.mark.parametrize("net", NETS)
def test_main_trains_on_cpu(net):
    losses = TEX.main(["--device", "cpu", "--network", net, "--num-epochs",
                       "1", "--data-dir", "/nonexistent"])
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert abs(losses[0] - np.log(10)) < 0.05
