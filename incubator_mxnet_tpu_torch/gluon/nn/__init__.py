"""Layers of the ResNet path."""
from .basic_layers import Dense, Flatten, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Dense", "Flatten", "HybridSequential", "Conv2D",
           "GlobalAvgPool2D", "MaxPool2D"]
