"""Layers of the vision zoo."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Dropout, Flatten, HybridLambda,
                           HybridSequential)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Flatten",
           "HybridLambda", "HybridSequential", "AvgPool2D", "Conv2D",
           "GlobalAvgPool2D", "GlobalMaxPool2D", "MaxPool2D"]
