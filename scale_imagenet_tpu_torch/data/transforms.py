"""ImageNet eval transforms with torchvision-matching numerics, PIL-backed
(counterpart of ``scale_imagenet_tpu/data/transforms.py``).

Resize(256) + CenterCrop(224) (+ Normalize), HWC layout as in the JAX
package.  Pillow is imported inside the functions that use it, so the
package imports where Pillow is absent (the shard path needs numpy only).
The train transforms come with training (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_float_chw_last(img) -> np.ndarray:
    """PIL -> HWC float32 in [0,1] (ToTensor without the CHW transpose)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    return arr


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    return (arr - mean) / std


def _resize_shorter(img, size: int):
    """torchvision Resize(int): the long edge is TRUNCATED
    (``int(size * long / short)``); rounding would shift the crop window
    by a pixel for about half the non-integer aspect ratios."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        ow, oh = size, max(int(size * h / w), 1)
    else:
        oh, ow = size, max(int(size * w / h), 1)
    return img.resize((ow, oh), Image.BILINEAR)


def _center_crop(img, size: int):
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def imagenet_eval_crop_u8(img) -> np.ndarray:
    """Resize(256) -> CenterCrop(224), kept as HWC uint8: the storage stage
    of the shard pipeline (``data/shards.py``); normalization runs on the
    device, and u8 -> f32 is exact, so the split loses nothing."""
    img = img.convert("RGB")
    img = _center_crop(_resize_shorter(img, 256), 224)
    return np.asarray(img, dtype=np.uint8)


def imagenet_eval_transform(img) -> np.ndarray:
    """Resize(256) -> CenterCrop(224) -> Normalize; HWC float32."""
    return _normalize(_to_float_chw_last(imagenet_eval_crop_u8(img)),
                      IMAGENET_MEAN, IMAGENET_STD)
