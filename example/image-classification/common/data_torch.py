"""Data iterators for image classification over the PyTorch port (the
twin of ``data.py``; reference: example/image-classification/common/
data.py — RecordIO iterators + the synthetic benchmark iterator). The
synthetic batches are made on the current context (``fit_torch`` runs
under the card's); the record iterators give host batches, which the
device feed or ``Module`` copies to the card."""
import os

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch, DataIter, ImageRecordIter


class SyntheticDataIter(DataIter):
    """Device-resident synthetic images (reference common/data.py synthetic
    iterator used by benchmark_score.py)."""

    def __init__(self, num_classes, data_shape, max_iter, dtype="float32"):
        super().__init__(data_shape[0])
        self.cur_iter = 0
        self.max_iter = max_iter
        rs = np.random.RandomState(0)
        label = rs.randint(0, num_classes, (data_shape[0],)).astype(dtype)
        data = rs.uniform(-1, 1, data_shape).astype(dtype)
        self.data = mx.nd.array(data)
        self.label = mx.nd.array(label)
        from mxnet_tpu_torch.io.io import DataDesc
        self.provide_data = [DataDesc("data", data_shape)]
        self.provide_label = [DataDesc("softmax_label", (data_shape[0],))]

    def next(self):
        self.cur_iter += 1
        if self.cur_iter > self.max_iter:
            raise StopIteration
        return DataBatch(data=[self.data], label=[self.label], pad=0)

    def iter_next(self):
        return self.cur_iter <= self.max_iter

    def reset(self):
        self.cur_iter = 0


def add_data_args(parser):
    data = parser.add_argument_group("Data")
    data.add_argument("--data-train", type=str, default=None,
                      help="training RecordIO file")
    data.add_argument("--data-val", type=str, default=None)
    data.add_argument("--image-shape", type=str, default="3,224,224")
    data.add_argument("--num-examples", type=int, default=1281167)
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939")
    data.add_argument("--benchmark", type=int, default=0,
                      help="use synthetic device-resident data")
    return data


def get_rec_iter(args, kv=None):
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark or not args.data_train:
        train = SyntheticDataIter(args.num_classes,
                                  (args.batch_size,) + image_shape,
                                  max_iter=args.num_examples // args.batch_size)
        return train, None
    mean = [float(x) for x in args.rgb_mean.split(",")]
    train = ImageRecordIter(path_imgrec=args.data_train,
                            data_shape=image_shape,
                            batch_size=args.batch_size,
                            shuffle=True, rand_crop=True, rand_mirror=True,
                            mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
                            ctx=mx.cpu())
    val = None
    if args.data_val:
        val = ImageRecordIter(path_imgrec=args.data_val,
                              data_shape=image_shape,
                              batch_size=args.batch_size,
                              mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
                              ctx=mx.cpu())
    return train, val
