"""Pre-decoded uint8 shards (counterpart of ``scale_imagenet_tpu/data/shards.py``).

Decode once into HWC uint8 ``.npy`` shards (the eval crop, Resize(256) +
CenterCrop(224), or the train pre-crop, Resize(256) + CenterCrop(256)); serve
epochs from the page cache and normalize, or augment, on the device
(``train/steps.py``).  The layout on disk is the JAX package's, so shards
written by either package load in the other:

    meta.json                  {"n": N, "shape": [H, W, C], "classes": [...]}
    images_00000.npy           (n_i, H, W, C) uint8
    labels_00000.npy           (n_i,) int32
    ...
"""

from __future__ import annotations

import bisect
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .loader import filler_batch, pad_batches

_META = "meta.json"


def _load_npy_fast(path: str) -> np.ndarray:
    """One sequential read and a zero-copy ``frombuffer``: ``np.load``
    reads a cold file in small chunks, many times slower."""
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = np.lib.format._read_array_header(
                f, version)
            data = np.frombuffer(f.read(), dtype)
        return data.reshape(shape, order="F" if fortran else "C")
    except (AttributeError, TypeError):
        # numpy moved the private header reader, or changed its signature
        return np.load(path)


def write_shards(dataset, out_dir: str, shard_size: int = 2048,
                 num_workers: int = 4) -> dict:
    """Decode ``dataset`` (items -> (HWC uint8 image, int label)) once into
    ``out_dir``; returns the meta dict.  Items are read on threads (PIL
    and libjpeg release the GIL)."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    shape = None
    written = 0
    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        for shard_idx, start in enumerate(range(0, n, shard_size)):
            idxs = range(start, min(start + shard_size, n))
            items = list(pool.map(dataset.__getitem__, idxs))
            images = np.stack([np.asarray(im, np.uint8) for im, _ in items])
            labels = np.asarray([lb for _, lb in items], np.int32)
            if shape is None:
                shape = list(images.shape[1:])
            np.save(os.path.join(out_dir, f"images_{shard_idx:05d}.npy"),
                    images)
            np.save(os.path.join(out_dir, f"labels_{shard_idx:05d}.npy"),
                    labels)
            written += len(items)
    meta = {"n": written, "shape": shape,
            "classes": list(getattr(dataset, "classes", []))}
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f)
    return meta


class ShardDataset:
    """View over a shard directory.  ``__getitem__`` (memmap random access,
    ``(u8 HWC, label)``) composes with ``DataLoader``; ``iter_batches`` is
    the fast path: whole shards read sequentially two ahead on threads,
    batches sliced as views, no per-item Python work."""

    def __init__(self, root: str):
        with open(os.path.join(root, _META)) as f:
            self.meta = json.load(f)
        self.classes = self.meta["classes"]
        self._paths = []
        self._images = []
        self._labels = []
        self._offsets = [0]
        i = 0
        while True:
            p = os.path.join(root, f"images_{i:05d}.npy")
            if not os.path.exists(p):
                break
            img = np.load(p, mmap_mode="r")
            lbl = np.load(os.path.join(root, f"labels_{i:05d}.npy"))
            self._paths.append(p)
            self._images.append(img)
            self._labels.append(lbl)
            self._offsets.append(self._offsets[-1] + len(img))
            i += 1
        if self._offsets[-1] != self.meta["n"]:
            raise ValueError(
                f"shard dir {root}: meta.n={self.meta['n']} but shards "
                f"hold {self._offsets[-1]}")

    def __len__(self):
        return self.meta["n"]

    def __getitem__(self, idx: int):
        s = bisect.bisect_right(self._offsets, idx) - 1
        j = idx - self._offsets[s]
        return np.asarray(self._images[s][j]), int(self._labels[s][j])

    def iter_batches(self, batch_size: int, rank: int = 0, world: int = 1,
                     drop_last: bool = False, shuffle: int | None = None):
        """Yield ``(images u8 (B,H,W,C), labels i32 (B,))`` spanning shard
        boundaries, the trailing short batch unless ``drop_last``.

        ``shuffle``: an integer seed for the training order, drawn as the
        JAX package draws it: ``np.random.default_rng(shuffle)`` permutes
        the shard order, then the rows of each shard as it is read (vary
        the seed per epoch).

        ``rank``/``world``: each process serves the shards assigned
        round-robin to its rank, and every rank yields the same number of
        batches (``rank_batches``): short ranks pad their tail and append
        all-pad batches (labels -1).  Multi-process training (``drop_last``
        across ranks) comes with a later slice (``ROADMAP.md``)."""
        if world > 1 and drop_last:
            raise ValueError("drop_last across ranks is multi-process "
                             "training, not ported yet (see ROADMAP.md)")
        mine = [s for s in range(len(self._paths)) if s % world == rank]
        rng = None
        if shuffle is not None:
            rng = np.random.default_rng(shuffle)
            mine = [mine[i] for i in rng.permutation(len(mine))]
        ahead = 2

        def shard_stream():
            with ThreadPoolExecutor(ahead) as pool:
                futs = [pool.submit(_load_npy_fast, self._paths[s])
                        for s in mine[:ahead]]
                for j, s in enumerate(mine):
                    cur = futs[j].result()
                    if j + ahead < len(mine):
                        futs.append(pool.submit(
                            _load_npy_fast, self._paths[mine[j + ahead]]))
                    lbl = self._labels[s]
                    if rng is not None:
                        perm = rng.permutation(len(cur))
                        cur, lbl = cur[perm], lbl[perm]
                    yield cur, lbl

        batches = self._slice_batches(shard_stream(), batch_size, drop_last)
        if world == 1:
            yield from batches
            return
        count = 0
        for batch in pad_batches(batches, batch_size):
            count += 1
            yield batch
        for _ in range(self.rank_batches(batch_size, world) - count):
            yield filler_batch(batch_size, self.meta["shape"])

    def rank_batches(self, batch_size: int, world: int,
                     drop_last: bool = False) -> int:
        """The per-rank batch count every rank computes from the shared
        metadata: the most ceil count of any rank (short ranks emit filler
        batches); with ``drop_last`` the full-batch count (one rank)."""
        counts = [sum(len(self._images[s])
                      for s in range(r, len(self._paths), world))
                  for r in range(world)]
        if drop_last:
            return min((n // batch_size for n in counts), default=0)
        return max((-(-n // batch_size) for n in counts), default=0)

    @staticmethod
    def _slice_batches(shards, batch_size, drop_last):
        def join(parts):
            return np.ascontiguousarray(
                np.concatenate(parts) if len(parts) > 1 else parts[0])

        img_parts, lbl_parts, have = [], [], 0
        for img, lbl in shards:
            pos = 0
            while pos < len(img):
                take = min(batch_size - have, len(img) - pos)
                img_parts.append(img[pos:pos + take])
                lbl_parts.append(lbl[pos:pos + take])
                have += take
                pos += take
                if have == batch_size:
                    yield join(img_parts), join(lbl_parts)
                    img_parts, lbl_parts, have = [], [], 0
        if have and not drop_last:
            yield join(img_parts), join(lbl_parts)


def shard_loader(root: str, batch_size: int, drop_last: bool = False,
                 shuffle: bool = False, seed: int = 0):
    """An iterable over a shard dir, usable where ``DataLoader`` is:
    ``dataset``, ``len()``, ``set_epoch`` and a fresh ``iter_batches`` per
    pass; ``shuffle`` draws each epoch's order from ``seed + epoch``."""
    ds = ShardDataset(root)
    n_batches = ds.rank_batches(batch_size, 1, drop_last)

    class _Iter:
        dataset = ds
        _epoch = 0

        def set_epoch(self, epoch: int):
            self._epoch = epoch

        def __len__(self):
            return n_batches

        def __iter__(self):
            return ds.iter_batches(
                batch_size, drop_last=drop_last,
                shuffle=(seed + self._epoch) if shuffle else None)

    return _Iter()
