"""Input pipeline (counterpart of ``scale_imagenet_tpu/data/``): PIL-exact
eval transforms, ``ImageFolder``, the threaded loader with device
prefetch, and the pre-decoded uint8 shards.  Nothing here imports Pillow
until an image is read."""

from .dataset import ArrayDataset, ImageFolder
from .loader import DataLoader, device_prefetch, filler_batch, pad_batches
from .shards import ShardDataset, shard_loader, write_shards
from .transforms import IMAGENET_MEAN, IMAGENET_STD, \
    imagenet_eval_crop_u8, imagenet_eval_transform

__all__ = [
    "ArrayDataset", "ImageFolder", "DataLoader", "device_prefetch",
    "filler_batch", "pad_batches", "ShardDataset", "shard_loader",
    "write_shards", "IMAGENET_MEAN", "IMAGENET_STD", "imagenet_eval_crop_u8",
    "imagenet_eval_transform",
]
