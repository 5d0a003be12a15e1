"""``gluon.data`` (port of ``incubator_mxnet_tpu/gluon/data``): datasets,
samplers, ``DataLoader`` and the vision datasets and transforms."""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import (BatchSampler, FilterSampler, RandomSampler,
                      Sampler, SequentialSampler, SplitSampler)
from .dataloader import DataLoader, default_batchify_fn
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "FilterSampler",
           "BatchSampler", "SplitSampler", "DataLoader",
           "default_batchify_fn", "vision"]
