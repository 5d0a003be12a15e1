"""Layers of the vision zoo and of the word LM."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridLambda, HybridSequential, Lambda, Sequential)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "HybridLambda", "HybridSequential", "Lambda",
           "Sequential", "AvgPool2D", "Conv2D",
           "GlobalAvgPool2D", "GlobalMaxPool2D", "MaxPool2D"]
