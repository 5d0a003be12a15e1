"""``mx.io``: data iterators (port of ``incubator_mxnet_tpu/io``)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, MXDataIter,
                 NDArrayIter, PrefetchingIter, ResizeIter)
from .record_iter import (ImageDetRecordIter, ImageRecordIter,
                          ImageRecordUInt8Iter, MNISTIter)
from .resilient import (DataTimeoutError, ResilientIter, SkipBudgetExceeded,
                        WorkerDiedError)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MXDataIter", "ImageRecordIter",
           "ImageRecordUInt8Iter", "ImageDetRecordIter", "MNISTIter",
           "ResilientIter", "DataTimeoutError", "SkipBudgetExceeded",
           "WorkerDiedError"]
