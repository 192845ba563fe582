"""Stock BatchNorm, eval and training (counterpart of
``scale_imagenet_tpu/layers/norm.py:48-77``).

The parameters live in ``nn.BatchNorm1d/2d`` modules, so the state-dict
names are torch's; the arithmetic is the JAX package's formula
``(x - mean) * (weight / sqrt(var + eps)) + bias``.  In training the batch
mean and biased variance normalise, and the new running statistics
(momentum 0.1, the unbiased variance) are *returned*, not written: the
forward is a function of the module's values, as in the JAX package, so a
forward that runs twice (``torch.utils.checkpoint`` recomputes it during
the backward) cannot apply an update twice.  ``stats_bn`` comes with the
families that use it (``ROADMAP.md``).
"""

from __future__ import annotations

import torch
from torch import nn


def _channel_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:           # (N, C)
        return v
    if x.dim() == 4:           # NCHW
        return v.view(1, -1, 1, 1)
    raise ValueError(f"batch_norm expects 2-D or 4-D input, got {x.dim()}-D")


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               stats: dict | None = None,
               momentum: float = 0.1) -> torch.Tensor:
    """Stock torch BatchNorm, channel axis 1.  ``stats is None``: eval, the
    running statistics normalise.  Otherwise training: the batch statistics
    normalise, and ``stats[bn]`` receives the new running ``(mean, var)``
    (no gradient), for the caller to write once (``train/steps.py``)."""
    if stats is None:
        mean, var = bn.running_mean, bn.running_var
    else:
        axes = (0,) if x.dim() == 2 else (0, 2, 3)
        mean = x.mean(axes)
        var = x.var(axes, correction=0)        # biased: normalisation
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            stats[bn] = ((1 - momentum) * bn.running_mean + momentum * mean,
                         (1 - momentum) * bn.running_var
                         + momentum * unbiased)
    inv = bn.weight / torch.sqrt(var + bn.eps)
    return ((x - _channel_view(mean, x)) * _channel_view(inv, x)
            + _channel_view(bn.bias, x))


def bn_scale_bias(bn: nn.modules.batchnorm._BatchNorm):
    """Effective eval ``(scale, bias)`` of a BN — the BN-folding algebra."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale
