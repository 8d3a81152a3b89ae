#!/usr/bin/env python
"""ImageNet training over the PyTorch port (the twin of
``train_imagenet.py``; reference: example/image-classification/
train_imagenet.py). The north star's command on one card:
``train_imagenet_torch.py --network resnet-v1 --num-layers 50 --gpus 0
--kv-store device --benchmark 1`` (``--benchmark 1``: synthetic data on
the card; ``dist_*`` stores wait for more than one process).
"""
import argparse
import importlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(__file__))

import mxnet_tpu_torch as mx
from common import data_torch as data
from common import fit_torch as fit

if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="train imagenet",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-classes", type=int, default=1000)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    parser.set_defaults(network="resnet", num_layers=50, batch_size=32,
                        num_epochs=1, lr=0.1, lr_step_epochs="30,60,80")
    args = parser.parse_args()

    net_mod = importlib.import_module(
        "symbols." + args.network.replace("-v1", "") + "_torch")
    version = 1 if args.network.endswith("-v1") else 2
    sym = net_mod.get_symbol(num_classes=args.num_classes,
                             num_layers=args.num_layers,
                             image_shape=args.image_shape,
                             version=version)
    fit.fit(args, sym, data.get_rec_iter)
