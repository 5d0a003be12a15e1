"""Bucketed sentence iterator (port of ``incubator_mxnet_tpu/rnn/io.py``;
the reference's ``python/mxnet/rnn/io.py``: ``encode_sentences`` :30,
``BucketSentenceIter`` :84)."""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np

from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array as nd_array

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode tokenized sentences into integer ids, building ``vocab`` on
    the fly (io.py:30)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token is not None, \
                    "Unknown token %s" % word
                if unknown_token is not None and not new_vocab:
                    word = unknown_token
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads sentences into length buckets; emits batches with a
    ``bucket_key`` so BucketingModule binds one executor per length
    (io.py:84).  The batches are NDArrays on ``ctx`` (``None``: the
    card).  ``reset`` shuffles with Python's ``random`` and numpy's
    global state, as the reference does, so the same seeds give both
    packages the same batches."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT", ctx=None):
        super().__init__(batch_size)
        self.ctx = ctx
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, j in enumerate(counts)
                       if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data: List[List] = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # empty buckets still need 2-D arrays so reset()'s label shift works
        self.data = [np.asarray(i, dtype=dtype) if i
                     else np.empty((0, buckets[k]), dtype=dtype)
                     for k, i in enumerate(self.data)]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata: List = []
        self.ndlabel: List = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(batch_size, self.default_bucket_key),
                layout=self.layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(batch_size, self.default_bucket_key),
                layout=self.layout)]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(self.default_bucket_key, batch_size),
                layout=self.layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(self.default_bucket_key, batch_size),
                layout=self.layout)]
        else:
            raise ValueError("Invalid layout %s: must be NT or TN" % layout)

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd_array(buck, self.ctx, self.dtype))
            self.ndlabel.append(nd_array(label, self.ctx, self.dtype))

    def next(self):  # noqa: A003
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name, shape=label.shape,
                                    layout=self.layout)])
