"""Data pipeline of the port (counterpart of ``jittor_mlp_tpu/data``)."""

from .dataset import ArrayDataset, BatchIterator, ImageFolderDataset, make_augment
from .preprocess import (IMAGENET_MEAN, IMAGENET_STD, make_preprocess, normalize, patchify,
                         resize_bilinear)

__all__ = [
    "ArrayDataset",
    "BatchIterator",
    "ImageFolderDataset",
    "make_augment",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "make_preprocess",
    "normalize",
    "patchify",
    "resize_bilinear",
]
