"""Vision datasets (port of
``incubator_mxnet_tpu/gluon/data/vision/datasets.py``): ``MNIST``,
``FashionMNIST``, ``CIFAR10``, ``CIFAR100``, ``ImageRecordDataset`` and
``ImageFolderDataset``.

Nothing is downloaded: the datasets parse the standard files already on
disk under ``root`` (MNIST's idx-ubyte files, plain or gzipped; CIFAR's
binary batches) and raise when they are absent.  A default root under
``~/.mxnet`` is re-rooted under ``$MXNET_HOME`` when that is set.  Images
are HWC uint8 NDArrays on the CPU; labels are numpy values.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .... import context
from .... import recordio as _recordio
from ....util import data_dir
from ....ndarray import ndarray as _nd
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _host_image(img):
    return _nd.array(img, ctx=context.cpu(), dtype="uint8")


def _maybe_gzip_open(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(
        "%s(.gz) not found; nothing is downloaded: place the dataset files "
        "under the root directory" % path)


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        default_prefix = os.path.join("~", ".mxnet")
        if root.startswith(default_prefix):
            root = data_dir() + root[len(default_prefix):]
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its idx-ubyte files: (28, 28, 1) uint8 images, int32
    labels."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        image_file, label_file = (self._train_files if self._train
                                  else self._test_files)
        with _maybe_gzip_open(os.path.join(self._root, label_file)) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
        with _maybe_gzip_open(os.path.join(self._root, image_file)) as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(num, rows, cols, 1)
        self._data = _host_image(data)
        self._label = label


class FashionMNIST(MNIST):
    """Fashion-MNIST, in MNIST's file format."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from its binary batches: (32, 32, 3) uint8 images, int32
    labels."""

    _archive_dir = "cifar-10-batches-bin"
    _label_bytes = 1

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, 3072 + self._label_bytes)
        return (data[:, self._label_bytes:].reshape(
                    -1, 3, 32, 32).transpose(0, 2, 3, 1),
                data[:, self._label_bytes - 1].astype(np.int32))

    def _batch_files(self):
        if self._train:
            return ["data_batch_%d.bin" % i for i in range(1, 6)]
        return ["test_batch.bin"]

    def _get_data(self):
        base = self._root
        if os.path.isdir(os.path.join(base, self._archive_dir)):
            base = os.path.join(base, self._archive_dir)
        files = self._batch_files()
        for f in files:
            if not os.path.exists(os.path.join(base, f)):
                raise FileNotFoundError(
                    "%s not found under %s; nothing is downloaded: place the "
                    "binary CIFAR batches there" % (f, base))
        data, label = zip(*(self._read_batch(os.path.join(base, f))
                            for f in files))
        self._data = _host_image(np.concatenate(data))
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR-100: the coarse label, or the fine one with
    ``fine_label=True``."""

    _archive_dir = "cifar-100-binary"
    _label_bytes = 2

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batch_files(self):
        return ["train.bin"] if self._train else ["test.bin"]

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, 3072 + 2)
        label_col = 1 if self._fine else 0
        return (data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                data[:, label_col].astype(np.int32))


class ImageRecordDataset(RecordFileDataset):
    """Images and labels of a ``.rec`` file: ``(HWC uint8 image, the
    header's label)``, through ``transform`` when given."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = _recordio.unpack_img(record, self._flag)
        img = _host_image(img)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """``root/<class>/<image>``: a class a folder in sorted order
    (``synsets``), its ``.jpg``, ``.jpeg``, ``.png`` and ``.npy`` files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            with open(path, "rb") as fin:
                img = _recordio._imdecode(fin.read(), self._flag)
        img = _host_image(img)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
