"""Inception v3 of the port against the JAX package's.

Inception v3 takes no widths, and its last pool (8x8) needs the 8x8 map
that only 299 px inputs give (at 75 px the reference itself fails: the
map is 1x1 there).  So:

- the whole net at 299 px, batch 1: the eval forward against the
  reference (1e-4), and the launches of K3 down the card branch (its two
  stem pools and the max branches of Inception B and D: 4);
- a net of one block of each kind at small size (a 3x3 conv, A, B, C,
  D, E, global average pooling and the classifier at 19 px, batch 2):
  ``test_torch_zoo.check_first_step``, the eval forward and one training
  step held as MobileNet's (``test_torch_zoo_mobile.py``).  Three steps
  part by 2.7e-4 in the second loss, 57x the noise floor of a port net
  nudged by 1e-6: the reference's one-pass BN variance (ROADMAP Queue C)
  makes its first update differ from exact arithmetic by more than f32
  rounding does.
"""
import numpy as np
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.gluon.model_zoo.vision import inception as jinc

from incubator_mxnet_tpu_torch import _kernels, context, gluon
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import inception as tinc
from incubator_mxnet_tpu_torch.parallel import maxpool_idx

from test_torch_zoo import CLASSES, build_pair, check_eval, check_first_step


def _blocks(mod, nn):
    net = nn.HybridSequential()
    net.add(mod._make_basic_conv(channels=16, kernel_size=3),
            mod._make_A(8), mod._make_B(), mod._make_C(16), mod._make_D(),
            mod._InceptionE(), nn.GlobalAvgPool2D(), nn.Flatten(),
            nn.Dense(CLASSES))
    return net


def _port_blocks():
    with context.device_scope("cpu"):
        return _blocks(tinc, gluon.nn)


def test_inception_blocks_match_reference():
    check_first_step(lambda: _blocks(jinc, jgluon.nn), _port_blocks,
                     (2, 3, 19, 19))


class _Recorder:
    def __init__(self):
        self.launches = 0

    def launch(self, device, *args):
        self.launches += 1


def test_inception_v3_forward_matches_reference(monkeypatch):
    shape = (1, 3, 299, 299)
    jnet, tnet = build_pair(lambda: jinc.inception_v3(classes=CLASSES),
                               lambda: tinc.inception_v3(classes=CLASSES,
                                                         device="cpu"),
                               shape)
    x = np.random.RandomState(1).normal(size=shape).astype(np.float32)
    check_eval(jnet, tnet, x)
    monkeypatch.setattr(maxpool_idx, "_on_card", lambda t: True)
    rec = _Recorder()
    monkeypatch.setitem(_kernels.KERNELS, "maxpool_idx_fwd", rec)
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    assert rec.launches == 4
