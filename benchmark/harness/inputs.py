"""The general input generator: uint8 image shards from a traffic mix's
parameters and the seed.

Images are uniform noise and labels uniform over the classes, drawn on the
device shard by shard from a generator seeded by the run's seed, and
written in the program's shard layout (``meta.json``, ``images_XXXXX.npy``
(n, H, W, 3) uint8, ``labels_XXXXX.npy`` (n,) int32) under the run's
``TMPDIR``.  ``rows`` reads them back for the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def write_shards(out_dir: str, n: int, size: int, classes: int,
                 shard_size: int, seed: int, device) -> None:
    os.makedirs(out_dir, exist_ok=True)
    g = torch.Generator(device=device).manual_seed(seed)
    for i, start in enumerate(range(0, n, shard_size)):
        m = min(shard_size, n - start)
        images = torch.randint(0, 256, (m, size, size, 3), generator=g,
                               device=device, dtype=torch.uint8)
        labels = torch.randint(0, classes, (m,), generator=g,
                               device=device, dtype=torch.int32)
        np.save(os.path.join(out_dir, f"images_{i:05d}.npy"),
                images.cpu().numpy())
        np.save(os.path.join(out_dir, f"labels_{i:05d}.npy"),
                labels.cpu().numpy())
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": n, "shape": [size, size, 3], "classes": []}, f)


def rows(shard_dir: str, index: np.ndarray, shard_size: int):
    """``(images (k, H, W, 3) uint8, labels (k,) int64)`` of the global row
    indices ``index``."""
    images, labels = [], []
    cache: dict = {}
    for r in index:
        s, j = divmod(int(r), shard_size)
        if s not in cache:
            cache[s] = (np.load(os.path.join(shard_dir,
                                              f"images_{s:05d}.npy"),
                                mmap_mode="r"),
                        np.load(os.path.join(shard_dir,
                                              f"labels_{s:05d}.npy")))
        images.append(np.asarray(cache[s][0][j]))
        labels.append(int(cache[s][1][j]))
    return np.stack(images), np.asarray(labels, np.int64)


def train_order(n: int, shard_size: int, batch: int, seed: int,
                epoch: int) -> list:
    """The global rows of each full batch of one shuffled training epoch,
    by the rule the shard loader states: ``np.random.default_rng(seed +
    epoch)`` permutes the shard order, then the rows of each shard as it
    is read; the batches run across shard boundaries and the short tail is
    dropped."""
    rng = np.random.default_rng(seed + epoch)
    sizes = [min(shard_size, n - s) for s in range(0, n, shard_size)]
    stream = []
    for s in rng.permutation(len(sizes)):
        stream.extend(int(s) * shard_size + rng.permutation(sizes[s]))
    return [np.asarray(stream[i:i + batch])
            for i in range(0, len(stream) - batch + 1, batch)]
