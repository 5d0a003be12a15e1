"""The port's metrics and losses against the JAX package's.

Metrics: every registered metric gets the same numpy labels and
predictions (two ``update`` calls) on both sides, given as each
package's NDArrays; ``get()`` and ``get_global()`` agree within 1e-6
relative (numpy on both sides).

Losses: each of the 13 losses at ranks 2 to 4 (``CosineEmbeddingLoss``
at rank 2, ``CTCLoss`` at its (N, T, C) and (T, N, C) layouts: the
reference takes no others), with a non-default
``axis`` where it has one, a ``weight``, a ``sample_weight`` and a
non-default ``batch_axis`` where they apply.  The loss values and the
gradient of their sum with respect to ``pred`` (through each package's
``autograd``, the port's NDArray path of ``HybridBlock``) agree within
1e-5 (f32).  C3: ``SoftmaxCrossEntropyLoss`` on logits (4, 3, 5) with
labels (4, 3) returns one loss per sample, shape (4,), as the
reference does.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import loss as jloss

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch.gluon import loss as tloss

CPU = tmx.cpu()


def _jnd(a):
    return jmx.nd.array(a)


def _tnd(a):
    return tmx.nd.array(a, ctx=CPU)


# -------------------------------------------------------------- metrics
def _metric_data(kind):
    rng = np.random.RandomState(1)
    n, c = 12, 4
    if kind == "classes":
        preds = [rng.rand(n, c).astype(np.float32) for _ in range(2)]
        preds = [p / p.sum(axis=1, keepdims=True) for p in preds]
        labels = [rng.randint(0, c, n).astype(np.float32)
                  for _ in range(2)]
    elif kind == "binary":
        preds = [rng.rand(n, 2).astype(np.float32) for _ in range(2)]
        labels = [rng.randint(0, 2, n).astype(np.float32)
                  for _ in range(2)]
    else:  # regression
        preds = [rng.normal(size=(n,)).astype(np.float32)
                 for _ in range(2)]
        labels = [(p + 0.3 * rng.normal(size=(n,))).astype(np.float32)
                  for p in preds]
    return labels, preds


METRICS = [
    ("acc", {}, "classes"), ("top_k_accuracy", {"top_k": 2}, "classes"),
    ("f1", {}, "binary"), ("mcc", {}, "binary"), ("pcc", {}, "classes"),
    ("perplexity", {"ignore_label": 3}, "classes"), ("mae", {}, "reg"),
    ("mse", {}, "reg"), ("rmse", {}, "reg"), ("ce", {}, "classes"),
    ("nll_loss", {}, "classes"), ("pearsoncorrelation", {}, "reg"),
    ("loss", {}, "reg"), ("torch", {}, "reg"), ("caffe", {}, "reg"),
    (["acc", "ce"], {}, "classes"),
]


def _metric(pkg, name, kw):
    if name == "custom":
        return pkg.metric.np(lambda label, pred: float(
            np.abs(label - pred).max()), name="maxerr")
    return pkg.metric.create(name, **kw)


@pytest.mark.parametrize("name,kw,kind", METRICS + [("custom", {}, "reg")],
                         ids=lambda v: str(v))
def test_metric_matches_reference(name, kw, kind):
    labels, preds = _metric_data(kind)
    got = {}
    for pkg, make in ((jmx, _jnd), (tmx, _tnd)):
        m = _metric(pkg, name, kw)
        for y, p in zip(labels, preds):
            m.update([make(y)], [make(p)])
        # the reference's composite has no global counters
        glob = None if isinstance(name, list) else m.get_global()
        got[pkg] = (m.get(), glob, m.get_name_value())
    (jget, jglob, jnv), (tget, tglob, tnv) = got[jmx], got[tmx]
    assert jget[0] == tget[0] and [n for n, _ in jnv] == [n for n, _ in tnv]
    np.testing.assert_allclose(np.asarray(tget[1], np.float64),
                               np.asarray(jget[1], np.float64), rtol=1e-6)
    if jglob is not None:
        np.testing.assert_allclose(tglob[1], jglob[1], rtol=1e-6)


def test_metric_reset_and_registry():
    m = tmx.metric.Accuracy()
    m.update([_tnd(np.array([1.0, 0.0]))],
             [_tnd(np.array([[0.2, 0.8], [0.9, 0.1]], np.float32))])
    assert m.get() == ("accuracy", 1.0)
    m.reset()
    assert np.isnan(m.get()[1])
    with pytest.raises(ValueError):
        tmx.metric.create("nosuch")


# --------------------------------------------------------------- losses
def _loss_cases():
    """(name, kwargs, inputs): inputs are (pred, label_or_extra...,
    sample_weight or None) as numpy, built per rank."""
    rng = np.random.RandomState(3)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    cases = []
    for rank in (2, 3, 4):
        shape = (4, 3, 5, 2)[:rank]
        sw_shape = (4,) + (1,) * (rank - 1)
        sw = rng.rand(*sw_shape).astype(np.float32)
        pos = rng.rand(*shape).astype(np.float32)
        bin01 = rng.randint(0, 2, shape).astype(np.float32)
        signed = 2 * bin01 - 1
        probs = rng.rand(*shape).astype(np.float32)
        probs = probs / probs.sum(axis=-1, keepdims=True)
        tag_ = "r%d" % rank
        cases += [
            ("L2Loss", {"weight": 0.7}, (r(*shape), r(*shape), sw), tag_),
            ("L1Loss", {"weight": 1.5}, (r(*shape), r(*shape), sw), tag_),
            ("SigmoidBinaryCrossEntropyLoss", {"weight": 2.0},
             (r(*shape), bin01, sw), tag_),
            ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
             (rng.rand(*shape).astype(np.float32) * 0.9 + 0.05, bin01,
              None), tag_),
            ("SoftmaxCrossEntropyLoss", {"axis": 1, "weight": 0.5},
             (r(*shape), rng.randint(0, shape[1], shape[:1] + shape[2:])
              .astype(np.float32), sw), tag_),
            ("SoftmaxCrossEntropyLoss", {"sparse_label": False,
                                         "from_logits": True},
             (np.log(probs), probs, sw), tag_),
            ("KLDivLoss", {"from_logits": False, "axis": 1},
             (r(*shape), probs, sw), tag_),
            ("HuberLoss", {"rho": 0.5, "weight": 1.2},
             (r(*shape), r(*shape), sw), tag_),
            ("HingeLoss", {"margin": 0.8}, (r(*shape), signed, sw), tag_),
            ("SquaredHingeLoss", {}, (r(*shape), signed, sw), tag_),
            ("LogisticLoss", {}, (r(*shape), signed, sw), tag_),
            ("LogisticLoss", {"label_format": "binary"},
             (r(*shape), bin01, None), tag_),
            ("TripletLoss", {"margin": 0.5},
             (r(*shape), r(*shape), r(*shape), sw.reshape(4)), tag_),
            ("PoissonNLLLoss", {"compute_full": True},
             (r(*shape), np.abs(r(*shape)) * 3, sw), tag_),
            ("PoissonNLLLoss", {"from_logits": False},
             (pos + 0.1, np.abs(r(*shape)), None), tag_),
        ]
        if rank == 2:
            # (N, D) pairs: the reference takes no other rank
            cases.append(("CosineEmbeddingLoss", {"margin": 0.2},
                          (r(*shape), r(*shape), signed[:, 0].copy(), None),
                          tag_))
        if rank == 3:
            # batch on axis 1: (3, 4, 5) with the per-sample mean kept
            cases.append(("L2Loss", {"batch_axis": 1},
                          (r(3, 4, 5), r(3, 4, 5), None), "b1"))
            cases.append(("SoftmaxCrossEntropyLoss",
                          {"axis": -1, "batch_axis": 1},
                          (r(3, 4, 5), rng.randint(0, 5, (3, 4))
                           .astype(np.float32), None), "b1"))
    # CTC: (N, T, C) activations, labels padded with -1, both layouts
    ctc_pred = r(3, 8, 5)
    ctc_label = np.array([[1, 2, -1], [3, 3, 1], [0, -1, -1]], np.float32)
    cases.append(("CTCLoss", {}, (ctc_pred, ctc_label, None), "ntc"))
    cases.append(("CTCLoss", {"layout": "TNC", "label_layout": "TN",
                              "weight": 0.5},
                  (ctc_pred.transpose(1, 0, 2).copy(), ctc_label.T.copy(),
                   None), "tnc"))
    return cases


CASES = _loss_cases()


def _run_loss(pkg, ag, make, name, kw, inputs):
    fn = getattr(pkg.gluon.loss if pkg is tmx else jloss, name)(**kw)
    pred = make(inputs[0])
    pred.attach_grad()
    others = [make(a) for a in inputs[1:-1]]
    sw = inputs[-1]
    args = others + ([make(sw)] if sw is not None else [])
    with ag.record():
        out = fn(pred, *args)
        total = out.sum()
    total.backward()
    return out.asnumpy(), pred.grad.asnumpy()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%s-%d" % (c[0], c[3], i)
                              for i, c in enumerate(CASES)])
def test_loss_matches_reference(case):
    name, kw, inputs, _ = CASES[case]
    jout, jgrad = _run_loss(jmx, jag, _jnd, name, kw, inputs)
    tout, tgrad = _run_loss(tmx, tag, _tnd, name, kw, inputs)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-5, atol=1e-5)


def test_c3_softmax_ce_is_per_sample():
    """C3: logits (4, 3, 5), labels (4, 3): one loss per sample."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(4, 3, 5)).astype(np.float32)
    y = rng.randint(0, 5, (4, 3)).astype(np.float32)
    jout = jloss.SoftmaxCrossEntropyLoss()(_jnd(x), _jnd(y)).asnumpy()
    tout = tloss.SoftmaxCrossEntropyLoss()(_tnd(x), _tnd(y)).asnumpy()
    assert jout.shape == tout.shape == (4,)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-6)


def test_loss_on_tensors_keeps_the_tensor_path():
    """Called on tensors, a loss is a module over tensors (TrainStep's
    path): rank-2 logits give the per-sample values."""
    import torch

    rng = np.random.RandomState(6)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    y = np.array([0, 4, 2, 9], np.float32)
    out = tloss.SoftmaxCrossEntropyLoss()(torch.from_numpy(x),
                                          torch.from_numpy(y))
    logp = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
    want = -logp[np.arange(4), np.clip(y.astype(int), 0, 4)]
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)
