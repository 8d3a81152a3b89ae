"""Bucketed sequence data iterators (the legacy ``mx.rnn`` API).

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference ``python/mxnet/rnn/io.py``):
``encode_sentences`` builds a vocabulary, ``BucketSentenceIter`` groups
variable-length sequences into a few padded bucket lengths, one executor
each under ``BucketingModule``. Its shuffles draw from Python's ``random``
and numpy's global stream in the JAX package's order, so seeding both gives
both packages the same batches. The batches stay on the host, as
``NDArrayIter``'s do; the module copies them to its executors' device.
"""
from __future__ import annotations

import random

import numpy as np

from ..context import cpu
from ..io.io import DataIter, DataBatch, DataDesc
from .. import ndarray


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key='\n',
                     start_label=0, unknown_token=None):
    """Encode sentences (lists of tokens) to lists of ints and build vocab.

    Returns (encoded_sentences, vocab).
    """
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
                assert (new_vocab or unknown_token), \
                    "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Batched, bucketed iterator over encoded sentences.

    Each batch's ``bucket_key`` is the padded sequence length; used with
    ``BucketingModule`` so only len(buckets) executors are ever bound.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name='data', label_name='softmax_label', dtype='float32',
                 layout='NT'):
        super(BucketSentenceIter, self).__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(np.bincount([len(s) for s in sentences]))
                       if j >= batch_size]
        buckets.sort()

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if ndiscard:
            import logging
            logging.warning("discarded %d sentences longer than the largest bucket.",
                            ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find('N')
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(name=data_name,
                                          shape=(batch_size, self.default_bucket_key))]
            self.provide_label = [DataDesc(name=label_name,
                                           shape=(batch_size, self.default_bucket_key))]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(name=data_name,
                                          shape=(self.default_bucket_key, batch_size))]
            self.provide_label = [DataDesc(name=label_name,
                                           shape=(self.default_bucket_key, batch_size))]
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) or TN (time major)")

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in range(0, len(buck) - batch_size + 1,
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
            self.nddata.append(ndarray.array(buck, ctx=cpu(),
                                             dtype=self.dtype))
            self.ndlabel.append(ndarray.array(label, ctx=cpu(),
                                              dtype=self.dtype))

    def next(self):
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

        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(name=self.data_name,
                                                shape=data.shape)],
                         provide_label=[DataDesc(name=self.label_name,
                                                 shape=label.shape)])
