"""Datasets (counterpart of ``scale_imagenet_tpu/data/dataset.py``).

``ImageFolder`` keeps torchvision's contract: one subdirectory per class,
classes sorted, so label indices match the reference's eval pipeline.
Pillow is imported when an image is read.
"""

from __future__ import annotations

import os

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
