"""Datasets (counterpart of ``scale_imagenet_tpu/data/dataset.py``).

``ImageFolder`` keeps torchvision's contract: one subdirectory per class,
classes sorted, so label indices match the reference's eval pipeline.
``CIFAR10`` (the pickled batches), ``MNIST`` (the idx files), ``tiny_imagenet``
and ``make_dataset_loader`` (the reference's per-dataset loader factory)
read local copies; they are library functions, which no CLI flag reaches
(the CLI reads shards or an ImageFolder).  Pillow is imported when an
image is read.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from functools import partial

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
             ".tiff", ".webp")


class ImageFolder:
    def __init__(self, root: str, transform=None):
        self.root = root
        self.transform = transform
        self.classes = sorted(
            d.name for d in os.scandir(root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for dirpath, _, filenames in sorted(os.walk(cdir)):
                for fn in sorted(filenames):
                    if fn.lower().endswith(_IMG_EXTS):
                        self.samples.append(
                            (os.path.join(dirpath, fn), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.transform is not None:
                img = self.transform(img)
        return img, label


class ArrayDataset:
    """In-memory ``(images, labels)`` pairs."""

    def __init__(self, images, labels, transform=None):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} "
                             "labels")
        self.images, self.labels = images, labels
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])


class CIFAR10:
    """CIFAR-10 from the standard pickled batches under
    ``root/cifar-10-batches-py`` (torchvision's ``CIFAR10`` without
    downloads).  Items are HWC uint8 arrays through ``transform`` (as PIL
    images), else HWC float32 in [0, 1]."""

    def __init__(self, root: str, train: bool = True, transform=None):
        self.transform = transform
        base = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train \
            else ["test_batch"]
        images, labels = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"])
            labels.extend(d[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = np.transpose(data, (0, 2, 3, 1))   # HWC uint8
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        img = self.images[idx]
        if self.transform is not None:
            from PIL import Image

            img = self.transform(Image.fromarray(img))
        else:
            img = img.astype(np.float32) / 255.0
        return img, int(self.labels[idx])


class MNIST:
    """MNIST from the standard idx-ubyte files (torchvision's ``MNIST``
    without downloads), in torchvision's layout ``root/MNIST/raw/...`` or
    directly under ``root``, ``.gz`` or not.  Items are (H, W) uint8
    through ``transform`` (as PIL 'L' images), else (H, W, 1) float32 in
    [0, 1]."""

    _FILES = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str, train: bool = True, transform=None):
        self.transform = transform
        img_name, lbl_name = self._FILES[train]
        self.images = _read_idx(_find_idx(root, img_name))  # (N, 28, 28)
        self.labels = _read_idx(_find_idx(root, lbl_name)).astype(np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        img = self.images[idx]
        if self.transform is not None:
            from PIL import Image

            img = self.transform(Image.fromarray(img, mode="L"))
        else:
            img = (img.astype(np.float32) / 255.0)[..., None]
        return img, int(self.labels[idx])


def _find_idx(root: str, name: str) -> str:
    for base in (os.path.join(root, "MNIST", "raw"), root):
        for suffix in ("", ".gz"):
            p = os.path.join(base, name + suffix)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(f"{name}[.gz] not under {root} or "
                            f"{root}/MNIST/raw")


def _read_idx(path: str) -> np.ndarray:
    """An idx file: a big-endian magic whose low byte is the rank, the
    dimensions, then uint8 data."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, = struct.unpack(">i", f.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}i", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def tiny_imagenet(root: str, train: bool, transform=None) -> ImageFolder:
    """tiny-imagenet-200 as the reference reads it: an ImageFolder over
    ``root/tiny-imagenet-200/{train,val}`` (the stock val split, flat
    images and an annotations file, must first be made one directory a
    class, as the reference requires)."""
    split = "train" if train else "val"
    return ImageFolder(os.path.join(root, "tiny-imagenet-200", split),
                       transform)


def make_dataset_loader(dataset: str, data_dir: str, train: bool,
                        batch_size: int, nchannel: int = 3,
                        num_workers: int = 4, seed: int = 0):
    """The reference's per-dataset loader factory (``netbin.py:960-1061``,
    ``scale_imagenet_tpu/data/dataset.py:166-197``): ``MNIST``, ``CIFAR10``
    or ``Tiny``, grayscale when ``nchannel == 1``, shuffled and on worker
    threads for training only.  Returns a ``DataLoader`` of HWC float32
    batches in [0, 1] and int labels."""
    from .loader import DataLoader
    from .transforms import grayscale_transform, tiny_train_transform, \
        to_tensor_transform

    if dataset == "MNIST":
        ds = MNIST(data_dir, train=train, transform=to_tensor_transform)
    elif dataset == "CIFAR10":
        tf = grayscale_transform if nchannel == 1 else to_tensor_transform
        ds = CIFAR10(data_dir, train=train, transform=tf)
    elif dataset == "Tiny":
        if train:
            tf = partial(tiny_train_transform, nchannel=nchannel)
        else:
            tf = grayscale_transform if nchannel == 1 \
                else to_tensor_transform
        ds = tiny_imagenet(data_dir, train, tf)
    else:
        raise ValueError(f"unknown dataset {dataset!r} "
                         "(MNIST | CIFAR10 | Tiny)")
    return DataLoader(ds, batch_size, shuffle=train,
                      num_workers=num_workers if train else 0, seed=seed)
