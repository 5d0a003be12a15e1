"""The model zoo's ResNet v1 (stock BatchNorm) written in ``mx.np`` and
``mx.npx`` calls over the zoo net's parameters, trained with AdamW by one
``nd._multi_adamw_update`` call a step.

Every function takes the package as its first argument (``mx``): the
same code runs on ``incubator_mxnet_tpu_torch`` (on the card) and on
``incubator_mxnet_tpu`` (the reference, on the CPU).  The forward calls
the registered ops the Gluon zoo net calls (``Convolution``,
``BatchNorm`` in training mode, ``Activation``/``relu``, ``Pooling``: a
3x3/2 max pool at the stem and the global average, ``FullyConnected``)
and ``np.add`` for the residuals; the loss is ``npx.log_softmax``,
``npx.pick`` and ``np.mean``.  The input pipeline turns uint8 NHWC
images into normalized NCHW float32 with ``_image_resize``,
``_image_crop``, ``to_tensor`` and ``_image_normalize``.

Run it (the port, on the card; ``--device cpu`` on the CPU)::

    python3 example/numpy/resnet_np.py --model resnet18_v1 --batch 8 \\
        --image 64 --classes 10 --steps 3
"""
import argparse
import os
import sys
import time

import numpy as onp

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: zoo name -> (block, stages, channels), as ``resnet_spec``
SPECS = {
    "resnet18_v1": ("basic", (2, 2, 2, 2), (64, 64, 128, 256, 512)),
    "resnet34_v1": ("basic", (3, 4, 6, 3), (64, 64, 128, 256, 512)),
    "resnet50_v1": ("bottleneck", (3, 4, 6, 3), (64, 256, 512, 1024, 2048)),
    "resnet101_v1": ("bottleneck", (3, 4, 23, 3),
                     (64, 256, 512, 1024, 2048)),
    "resnet152_v1": ("bottleneck", (3, 8, 36, 3),
                     (64, 256, 512, 1024, 2048)),
}
EPS, MOMENTUM = 1e-5, 0.9
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


class NpState:
    """The trained state of the ``mx.np`` net: the zoo net's parameters
    copied into arrays of the package (in the net's order, with their
    names), the trained ones with a gradient buffer, and AdamW's moments
    of each trained one."""

    def __init__(self, mx, net, ctx=None):
        self.named = []
        self.trained = []
        for name, p in net.collect_params().items():
            a = mx.np.array(p.data(), ctx=ctx)
            if p.grad_req != "null":
                a.attach_grad()
                self.trained.append(len(self.named))
            self.named.append((name, a))
        self.mean = [mx.np.zeros(self.named[i][1].shape, ctx=ctx)
                     for i in self.trained]
        self.var = [mx.np.zeros(self.named[i][1].shape, ctx=ctx)
                    for i in self.trained]


class _Cursor:
    """The parameters in the order the zoo net makes them."""

    def __init__(self, named):
        self._named, self._i = named, 0

    def take(self):
        self._i += 1
        return self._named[self._i - 1][1]

    def next_is(self, suffix):
        return self._i < len(self._named) and \
            self._named[self._i][0].endswith(suffix)


def _conv(mx, p, x, kernel, stride, pad, channels):
    w = p.take()
    b = p.take() if p.next_is("bias") else None
    return mx.npx.convolution(x, w, b, kernel=(kernel, kernel),
                              stride=(stride, stride), pad=(pad, pad),
                              num_filter=channels, no_bias=b is None)


def _bn(mx, p, x, stats):
    gamma, beta, rm, rv = p.take(), p.take(), p.take(), p.take()
    out, mean, var = mx.npx.batch_norm(
        x, gamma, beta, rm, rv, eps=EPS, momentum=MOMENTUM, fix_gamma=False,
        output_mean_var=True)
    stats.append((rm, rv, mean, var))
    return out


def _basic(mx, p, x, channels, stride, downsample, stats):
    h = mx.npx.relu(_bn(mx, p, _conv(mx, p, x, 3, stride, 1, channels),
                        stats))
    h = _bn(mx, p, _conv(mx, p, h, 3, 1, 1, channels), stats)
    r = _bn(mx, p, _conv(mx, p, x, 1, stride, 0, channels), stats) \
        if downsample else x
    return mx.npx.relu(mx.np.add(h, r))


def _bottleneck(mx, p, x, channels, stride, downsample, stats):
    mid = channels // 4
    h = mx.npx.relu(_bn(mx, p, _conv(mx, p, x, 1, stride, 0, mid), stats))
    h = mx.npx.relu(_bn(mx, p, _conv(mx, p, h, 3, 1, 1, mid), stats))
    h = _bn(mx, p, _conv(mx, p, h, 1, 1, 0, channels), stats)
    r = _bn(mx, p, _conv(mx, p, x, 1, stride, 0, channels), stats) \
        if downsample else x
    return mx.npx.relu(mx.np.add(h, r))


def forward(mx, named, x, spec):
    """Logits of the zoo ResNet v1 ``spec`` (a ``SPECS`` value) with the
    parameters ``named`` in training mode, and each BatchNorm's (running
    mean, running var, batch mean, batch var)."""
    block, stages, channels = spec
    unit = _basic if block == "basic" else _bottleneck
    p, stats = _Cursor(named), []
    h = mx.npx.relu(_bn(mx, p, _conv(mx, p, x, 7, 2, 3, channels[0]), stats))
    h = mx.npx.pooling(h, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for i, n in enumerate(stages):
        for j in range(n):
            h = unit(mx, p, h, channels[i + 1], 1 if i == 0 or j else 2,
                     j == 0 and channels[i + 1] != channels[i], stats)
    h = mx.npx.pooling(h, kernel=(1, 1), global_pool=True, pool_type="avg")
    w = p.take()
    b = p.take()
    return mx.npx.fully_connected(h, w, b, num_hidden=w.shape[0]), stats


def cross_entropy(mx, logits, labels):
    """The batch's mean softmax cross-entropy."""
    picked = mx.npx.pick(mx.npx.log_softmax(logits), labels)
    return mx.np.negative(mx.np.mean(picked))


def update_running_stats(mx, stats):
    """MXNet's momentum: ``m * running + (1 - m) * batch``."""
    for rm, rv, mean, var in stats:
        rm[:] = mx.np.add(mx.np.multiply(rm, MOMENTUM),
                          mx.np.multiply(mean, 1 - MOMENTUM))
        rv[:] = mx.np.add(mx.np.multiply(rv, MOMENTUM),
                          mx.np.multiply(var, 1 - MOMENTUM))


def adamw_arrays(state, grads=None):
    """(weight, grad, mean, var) of each trained parameter, in order."""
    arrays = []
    for k, i in enumerate(state.trained):
        w = state.named[i][1]
        g = w.grad if grads is None else grads[k]
        arrays += [w, g, state.mean[k], state.var[k]]
    return arrays


def adamw_update(mx, state, lr, wd, grads=None, **hyper):
    """Every trained parameter updated by one ``_multi_adamw_update``
    call; returns its outputs."""
    n = len(state.trained)
    outs = mx.nd._multi_adamw_update(
        *adamw_arrays(state, grads), num_weights=n, lrs=[lr] * n,
        wds=[wd] * n, etas=[1.0] * n, **hyper)
    for k, i in enumerate(state.trained):
        state.named[i][1][:] = outs[3 * k]
        state.mean[k][:] = outs[3 * k + 1]
        state.var[k][:] = outs[3 * k + 2]
    return outs


def train_step(mx, state, x, labels, spec, lr=1e-3, wd=1e-4):
    """One step: the forward and loss under ``autograd.record()``, the
    backward, the running stats, the AdamW update.  Returns (loss,
    logits) before the update."""
    with mx.autograd.record():
        logits, stats = forward(mx, state.named, x, spec)
        loss = cross_entropy(mx, logits, labels)
    loss.backward()
    update_running_stats(mx, stats)
    adamw_update(mx, state, lr, wd)
    return loss, logits


def preprocess(mx, images, size=256, crop=224):
    """uint8 NHWC images to normalized NCHW float32: resized to
    ``size``, centre-cropped to ``crop``."""
    x = mx.nd._image_resize(images, size=(size, size))
    off = (size - crop) // 2
    x = mx.nd._image_crop(x, x0=off, y0=off, width=crop, height=crop)
    x = mx.nd.to_tensor(x)
    return mx.nd._image_normalize(x, mean=MEAN_STD[0], std=MEAN_STD[1])


def synthetic_batch(batch, height, width, classes, seed):
    """uint8 NHWC images and labels from ``seed``."""
    rng = onp.random.RandomState(seed)
    images = rng.randint(0, 256, (batch, height, width, 3)).astype(onp.uint8)
    return images, rng.randint(0, classes, batch).astype(onp.float32)


def main(argv=None):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, gluon, initializer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="resnet18_v1", choices=sorted(SPECS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = context.resolve(args.device)
    net = gluon.model_zoo.vision.get_model(args.model, classes=args.classes,
                                           device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(args.seed))
    gluon.shape_init(net, (1, 3, args.image, args.image))
    state = NpState(mx, net, ctx=dev)
    size = args.image * 8 // 7
    images, labels = synthetic_batch(args.batch, size + 16, size + 8,
                                     args.classes, args.seed)
    x = preprocess(mx, mx.nd.array(images, ctx=dev, dtype="uint8"),
                   size=size, crop=args.image)
    y = mx.np.array(labels, ctx=dev)
    for step in range(1, args.steps + 1):
        t = time.perf_counter()
        loss, _ = train_step(mx, state, x, y, SPECS[args.model], args.lr)
        value = float(loss.asnumpy())
        print("step %d loss %.5f  %.1f ms" % (
            step, value, (time.perf_counter() - t) * 1e3))
        if not onp.isfinite(value):
            raise SystemExit("loss is not finite")
    print("PASS")


if __name__ == "__main__":
    main()
