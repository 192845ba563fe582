"""Dense layers, float and weight-binarized (counterpart of
``scale_imagenet_tpu/layers/linear.py:38-96``).

Weights are torch's ``(out, in)``; the JAX package stores ``(in, out)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quantize import ste_round
from ..ops.weights import binarize_weights, uses_weight_mask


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    return F.linear(x, weight, bias)


class BinLinear(nn.Module):
    """The parameters of a weight-binarized linear layer: ``weight``
    ``(out, in)`` and, for the masked binarizers, ``weight_mask``."""

    def __init__(self, in_features: int, out_features: int,
                 binarizer: str = "ternary_mask"):
        super().__init__()
        self.binarizer = binarizer
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        if uses_weight_mask(binarizer):
            self.weight_mask = nn.Parameter(
                torch.zeros(out_features, in_features))
        else:
            self.register_parameter("weight_mask", None)
        self.register_parameter("bias", None)


def bias_from_bin_weight(weight: torch.Tensor) -> torch.Tensor:
    """The sum of ``relu(-w)`` over each output feature's inputs."""
    return torch.relu(-weight).sum(dim=1)


def bin_linear(x: torch.Tensor, lin: BinLinear, rounding: bool = True,
               positive: bool = False,
               abs_weight: bool = False) -> torch.Tensor:
    """BinLinear / BinLinearPos (``linear.py:75``); ``abs_weight`` is
    BinLinearPosv2: the binarized weight's absolute value, with the (then
    zero) positive bias kept, as in the JAX package."""
    w = binarize_weights(lin.binarizer, lin.weight, lin.weight_mask)
    if abs_weight:
        w = w.abs()
        positive = True
    bias = bias_from_bin_weight(w) if positive else lin.bias
    y = linear(x, w, bias)
    return ste_round(y) if rounding else y
