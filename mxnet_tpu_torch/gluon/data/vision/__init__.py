"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100  # noqa: F401
from . import transforms  # noqa: F401
