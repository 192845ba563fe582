"""Input pipeline (counterpart of ``scale_imagenet_tpu/data/``): PIL-exact
eval and train transforms (ImageNet and the 32x32 CIFAR pipeline), ``ImageFolder``, the threaded loader with device
prefetch, and the pre-decoded uint8 shards.  Nothing here imports Pillow
until an image is read."""

from .dataset import ArrayDataset, ImageFolder
from .loader import DataLoader, device_prefetch, filler_batch, pad_batches
from .shards import ShardDataset, shard_loader, write_shards
from .transforms import CIFAR_MEAN, CIFAR_STD, IMAGENET_MEAN, \
    IMAGENET_STD, cifar_eval_transform, cifar_train_transform, \
    imagenet_eval_crop_u8, imagenet_eval_transform, imagenet_train_crop_u8, \
    imagenet_train_transform

__all__ = [
    "ArrayDataset", "ImageFolder", "DataLoader", "device_prefetch",
    "filler_batch", "pad_batches", "ShardDataset", "shard_loader",
    "write_shards", "CIFAR_MEAN", "CIFAR_STD", "IMAGENET_MEAN",
    "IMAGENET_STD", "cifar_eval_transform", "cifar_train_transform",
    "imagenet_eval_crop_u8",
    "imagenet_eval_transform", "imagenet_train_crop_u8",
    "imagenet_train_transform",
]
