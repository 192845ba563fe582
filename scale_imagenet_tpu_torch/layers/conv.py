"""Grouped 2-D convolutions, float and weight-binarized (counterpart of
``scale_imagenet_tpu/layers/conv.py:54-131``).

Activations are NCHW and weights OIHW here (the JAX package keeps NHWC and
HWIO; ``convert/from_jax.py`` transposes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quantize import ste_round
from ..ops.weights import binarize_weights, uses_weight_mask


def _as_pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride=1, padding=0,
           groups: int = 1) -> torch.Tensor:
    """Plain (grouped) conv; ``padding`` is a symmetric int or pair."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding,
                    groups=groups)


class BinConv2d(nn.Module):
    """The parameters of a weight-binarized conv: ``weight`` (OIHW), the
    learned ``weight_mask`` of the masked binarizers, and ``bias``, which
    is ``None`` until BN folding gives it one."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 groups: int = 1, binarizer: str = "ternary_mask"):
        super().__init__()
        self.binarizer = binarizer
        shape = (out_channels, in_channels // groups,
                 *_as_pair(kernel_size))
        self.weight = nn.Parameter(torch.zeros(shape))
        if uses_weight_mask(binarizer):
            self.weight_mask = nn.Parameter(torch.zeros(shape))
        else:
            self.register_parameter("weight_mask", None)
        self.register_parameter("bias", None)


def bias_from_bin_weight_conv(weight: torch.Tensor) -> torch.Tensor:
    """The positive-combination bias: the sum of ``relu(-w)`` over each
    output filter, so that -1 weights act as NOT gates (``conv.py:99``)."""
    return torch.relu(-weight).sum(dim=(1, 2, 3))


def bin_conv2d(x: torch.Tensor, conv: BinConv2d, stride=1, padding=0,
               groups: int = 1, rounding: bool = True,
               positive: bool = False) -> torch.Tensor:
    """The conv with ``conv``'s binarized weights; the output rounded
    (straight-through) when ``rounding``; the NOT-gate bias when
    ``positive``, else the module's own bias if it has one
    (``conv.py:108``)."""
    w = binarize_weights(conv.binarizer, conv.weight, conv.weight_mask)
    bias = bias_from_bin_weight_conv(w) if positive else conv.bias
    y = conv2d(x, w, bias, stride, padding, groups)
    return ste_round(y) if rounding else y
