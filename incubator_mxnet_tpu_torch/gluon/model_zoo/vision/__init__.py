"""Vision models: the ghost-BN ResNet v1."""
from .resnet import BottleneckV1, GhostBN, GhostBNReLU, ResNetV1, resnet50_v1

__all__ = ["BottleneckV1", "GhostBN", "GhostBNReLU", "ResNetV1",
           "resnet50_v1"]
