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


class StatsBN(nn.Module):
    """``BatchNormStatsCallbak``'s parameters and statistics
    (``norm.py:85``): ``weight`` of one entry when ``use_scalar_scale``,
    ``bias`` and ``running_mean`` per channel, ``running_var`` of
    ``weight``'s size, starting at zeros."""

    def __init__(self, dim: int, use_scalar_scale: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.use_scalar_scale = use_scalar_scale
        self.momentum, self.eps = momentum, eps
        dim_scale = 1 if use_scalar_scale else dim
        self.weight = nn.Parameter(torch.ones(dim_scale))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.zeros(dim_scale))


def stats_bn(bn: StatsBN, x: torch.Tensor, stats: dict | None = None,
             eval_with_bn: bool = False) -> torch.Tensor:
    """``BatchNormStatsCallbak``'s forward (``norm.py:101``), channel axis
    1: training when ``stats`` is given (the new running statistics go to
    ``stats[bn]``, as ``batch_norm``'s do), the batch statistics alone
    under ``eval_with_bn``, else the running ones."""
    if stats is not None or eval_with_bn:
        axes = (0,) if x.dim() == 2 else (0, 2, 3)
        var = x.var(correction=1).reshape(1) if bn.use_scalar_scale \
            else x.var(axes, correction=1)
        mean = x.mean(axes)
        if stats is not None and not eval_with_bn:
            m = bn.momentum
            with torch.no_grad():
                stats[bn] = (bn.running_mean * m + mean * (1 - m),
                             bn.running_var * m + var * (1 - m))
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = bn.weight / torch.sqrt(var + bn.eps)
    bias = bn.bias - mean * scale
    return x * _channel_view(scale, x) + _channel_view(bias, x)


class ScaleBias(nn.Module):
    """The ScaleBias head (``norm.py:140``): a scalar ``scale``, 1 / the
    number of classes at init, and a per-class ``bias``."""

    def __init__(self, nr_classes: int):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0 / nr_classes))
        self.bias = nn.Parameter(torch.zeros(nr_classes))


def scale_bias_layer(layer: ScaleBias, x: torch.Tensor) -> torch.Tensor:
    return layer.scale * x + layer.bias
