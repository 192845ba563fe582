"""ImageNet and CIFAR transforms with torchvision-matching numerics,
PIL-backed (counterpart of ``scale_imagenet_tpu/data/transforms.py``).

Eval: Resize(256) + CenterCrop(224) (+ Normalize).  Train:
RandomResizedCrop(224) + HFlip + ColorJitter(0.5, 0.5, 0.3) + Normalize,
drawn from an explicit ``random.Random``, and the 256x256 pre-crop that
train shards store for the on-device augmentation (``train/augment.py``).
The 32x32 models' pipeline (``transforms.py:132-150``): eval ToTensor +
Normalize with the CIFAR statistics; train HFlip + reflect-pad 4 +
RandomCrop(32) + Normalize with the ImageNet statistics, as the reference
does.  The library readers' transforms (``make_dataset_loader``):
ToTensor keeping the channel count, grayscale, and the Tiny training
rotation and flip.  HWC layout as in the JAX package.  Pillow is imported inside the functions
that use it, so the package imports where Pillow is absent (the shard path
needs numpy only).
"""

from __future__ import annotations

import math
import random

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


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


def imagenet_train_crop_u8(img) -> np.ndarray:
    """Resize(256) -> CenterCrop(256) as HWC uint8: the pre-crop that train
    shards store (``--write_shards --shards_split train``), so that the
    RandomResizedCrop + flip + ColorJitter run on the device
    (``train/augment.py``)."""
    img = img.convert("RGB")
    img = _center_crop(_resize_shorter(img, 256), 256)
    return np.asarray(img, dtype=np.uint8)


def _random_resized_crop(img, size: int, rng: random.Random,
                         scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop: 10 attempts, then the center crop."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return img.crop((left, top, left + cw, top + ch)).resize(
                (size, size), Image.BILINEAR)
    s = min(w, h)
    return _center_crop(img, s).resize((size, size), Image.BILINEAR)


def imagenet_train_transform(img, rng: random.Random | None = None) \
        -> np.ndarray:
    """RandomResizedCrop(224) -> HFlip -> ColorJitter(0.5, 0.5, 0.3) in a
    random order -> Normalize; HWC float32.  ``rng`` draws every choice
    (the ``random`` module's own generator when ``None``, as in the JAX
    package); the same state gives the JAX package's output exactly."""
    from PIL import Image, ImageEnhance

    rng = rng or random
    img = img.convert("RGB")
    img = _random_resized_crop(img, 224, rng)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    jitters = ((0.5, ImageEnhance.Brightness), (0.5, ImageEnhance.Contrast),
               (0.3, ImageEnhance.Color))
    order = list(range(3))
    rng.shuffle(order)
    for i in order:
        mag, enhancer = jitters[i]
        img = enhancer(img).enhance(rng.uniform(max(0.0, 1 - mag), 1 + mag))
    return _normalize(_to_float_chw_last(img), IMAGENET_MEAN, IMAGENET_STD)


def cifar_eval_transform(img) -> np.ndarray:
    """ToTensor + Normalize with the CIFAR statistics; HWC float32."""
    return _normalize(_to_float_chw_last(img), CIFAR_MEAN, CIFAR_STD)


def cifar_train_transform(img, rng: random.Random | None = None) \
        -> np.ndarray:
    """HFlip -> reflect-pad 4 -> RandomCrop(32) -> Normalize with the
    ImageNet statistics (the reference's choice); HWC float32, every
    choice drawn from ``rng`` in the JAX package's order."""
    from PIL import Image

    rng = rng or random
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.pad(_to_float_chw_last(img), ((4, 4), (4, 4), (0, 0)),
                 mode="reflect")
    top = rng.randint(0, arr.shape[0] - 32)
    left = rng.randint(0, arr.shape[1] - 32)
    return _normalize(arr[top:top + 32, left:left + 32], IMAGENET_MEAN,
                      IMAGENET_STD)


# The transforms of ``make_dataset_loader`` (``transforms.py:153-190``):
# MNIST, CIFAR10 and Tiny with the channel count kept, grayscale when
# nchannel == 1; Tiny training adds RandomRotation(20) + HFlip(0.5).  Bare
# ToTensor, no normalization, as the reference has it.

def _to_float_hwc(img) -> np.ndarray:
    """ToTensor keeping the channel count: an 'L' image stays one channel
    (``_to_float_chw_last`` repeats it to three for the RGB pipelines)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def to_tensor_transform(img) -> np.ndarray:
    """torchvision ToTensor in HWC layout: float32 in [0, 1]."""
    return _to_float_hwc(img)


def grayscale_transform(img) -> np.ndarray:
    """Grayscale(num_output_channels=1) + ToTensor: PIL's 'L' (ITU-R 601-2
    luma, as torchvision) -> (H, W, 1) float32."""
    return _to_float_hwc(img.convert("L"))


def tiny_train_transform(img, rng: random.Random | None = None,
                         nchannel: int = 3) -> np.ndarray:
    """RandomRotation(20) (angle ~ U(-20, 20), NEAREST, no expand) +
    RandomHorizontalFlip(0.5) + ToTensor, grayscale first when ``nchannel
    == 1``; every choice drawn from ``rng`` in the JAX package's order, so
    the same state gives its output exactly."""
    from PIL import Image

    rng = rng or random
    if nchannel == 1:
        img = img.convert("L")
    img = img.rotate(rng.uniform(-20.0, 20.0), resample=Image.NEAREST,
                     expand=False)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return _to_float_hwc(img)
