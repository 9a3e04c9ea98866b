"""Datasets (L6): numpy arrays on the host, binarization on the device."""
from .base import (ArrayDataset, binarize_batch, binarize_rows,
                   to_device_dataset)
from .loaders import (LOADERS, generate_bdp, load_cifar, load_dataset,
                      load_mnist, load_omniglot)

__all__ = ["ArrayDataset", "binarize_batch", "binarize_rows",
           "to_device_dataset", "LOADERS", "load_dataset", "load_mnist",
           "load_omniglot", "load_cifar", "generate_bdp"]
