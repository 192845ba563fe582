"""Pooling, padding and flatten (counterpart of ``scale_imagenet_tpu/layers/pool.py:20-55``).

NCHW here, so ``flatten`` is a plain reshape: torch's C·H·W feature order,
which the reference classifier weights expect.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool(x: torch.Tensor, window=2, stride=None) -> torch.Tensor:
    """AvgPool2d: no padding, odd sizes floor (torch)."""
    return F.avg_pool2d(x, window, stride if stride is not None else window)


def max_pool(x: torch.Tensor, window=2, stride=None) -> torch.Tensor:
    """MaxPool2d: VALID (no padding), odd sizes floor (``pool.py:29``)."""
    return F.max_pool2d(x, window, stride if stride is not None else window)


def zero_pad2d(x: torch.Tensor, pad: tuple) -> torch.Tensor:
    """torch ZeroPad2d order: ``(left, right, top, bottom)``."""
    return F.pad(x, tuple(pad))


def constant_pad2d(x: torch.Tensor, padding, value: float = 0.0) \
        -> torch.Tensor:
    """torch ConstantPad2d with a symmetric int or a 4-tuple."""
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    return F.pad(x, tuple(padding), value=value)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C*H*W)."""
    return x.reshape(x.shape[0], -1)
