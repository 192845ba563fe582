"""Misc utilities (counterpart of ``scale_imagenet_tpu/utils/misc.py``,
itself the reference's ``model_utils/utils.py`` and
``utils/preprocess.py`` support code).  Where JAX walks a params pytree,
these walk a module's named parameters."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class AverageMetric:
    """Streaming average (``misc.py:11``)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def add(self, value, n: int = 1):
        self._sum += float(value) * n
        self._count += n

    @property
    def avg(self) -> float:
        return self._sum / max(self._count, 1)

    @property
    def count(self) -> int:
        return self._count


class LimitedDatasetIter:
    """The first ``limit`` batches of a loader each epoch (``misc.py:31``)."""

    def __init__(self, loader, limit: int):
        self.loader = loader
        self.limit = limit

    def __len__(self):
        return min(len(self.loader), self.limit)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i >= self.limit:
                break
            yield batch


class ReplayDatasetIter:
    """The first epoch's batches, cached and replayed afterwards
    (``misc.py:49``)."""

    def __init__(self, loader):
        self.loader = loader
        self._cache = None

    def __len__(self):
        return len(self._cache) if self._cache is not None \
            else len(self.loader)

    def __iter__(self):
        if self._cache is not None:
            yield from self._cache
            return
        cache = []
        for batch in self.loader:
            cache.append(batch)
            yield batch
        self._cache = cache


def count_parameters(module: nn.Module, verbose: bool = True) -> int:
    """The parameter table and total (``misc.py:72``): every parameter of
    ``module`` (buffers, such as BN statistics, are JAX's ``state``, which
    it does not count)."""
    rows = [(name, p.numel()) for name, p in module.named_parameters()]
    total = sum(n for _, n in rows)
    if verbose:
        width = max((len(n) for n, _ in rows), default=10)
        for name, size in rows:
            print(f"{name:<{width}}  {size:>12,}")
        print(f"Total Trainable Params: {total:,}")
    return total


def rgb_to_hsv(img: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """RGB -> HSV (``misc.py:88``), HWC layout, H in degrees; the hue's
    branch is the channel that holds the minimum, the first on a tie."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    max_rgb = img.amax(dim=-1)
    min_rgb = img.amin(dim=-1)
    max_min = max_rgb - min_rgb + epsilon
    h1 = 60.0 * (g - r) / max_min + 60.0
    h2 = 60.0 * (b - g) / max_min + 180.0
    h3 = 60.0 * (r - b) / max_min + 300.0
    h = torch.stack([h2, h3, h1], dim=-1).gather(
        -1, img.argmin(dim=-1, keepdim=True))[..., 0]
    s = max_min / (max_rgb + epsilon)
    return torch.stack([h, s, max_rgb], dim=-1)


def get_mean_and_std(dataset, batches: int = 64):
    """Per-channel mean and std over the first ``batches`` items of
    ``dataset`` (``(image, label)`` pairs, channels last; ``misc.py:104``),
    in float64, returned as float32 arrays."""
    acc = acc_sq = None
    n = 0
    for i, (img, _) in enumerate(dataset):
        arr = np.asarray(img, dtype=np.float64)
        flat = arr.reshape(-1, arr.shape[-1])
        if acc is None:
            acc = np.zeros(arr.shape[-1])
            acc_sq = np.zeros(arr.shape[-1])
        acc += flat.sum(0)
        acc_sq += (flat ** 2).sum(0)
        n += flat.shape[0]
        if i + 1 >= batches:
            break
    mean = acc / n
    std = np.sqrt(acc_sq / n - mean ** 2)
    return mean.astype(np.float32), std.astype(np.float32)


def get_sparsity_stat(module: nn.Module):
    """Sparsity of the ``weight_mask`` parameters (``misc.py:124``): the
    zero share of each (``|w| < 1e-4``), the zeros and the mask weights in
    all."""
    parts, nr_zero, tot = [], 0, 0
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] == "weight_mask":
            nz = int((p.detach().abs() < 1e-4).sum())
            parts.append(nz / p.numel())
            nr_zero += nz
            tot += p.numel()
    return parts, nr_zero, tot


def cast_floating(module: nn.Module,
                  dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Every floating parameter and buffer of ``module`` in ``dtype``, in
    place (integer buffers untouched; ``misc.py:142``): ``--bf16``."""
    return module.to(dtype)
