"""FHE-friendly polynomial activation ``0.47 + 0.50 x + 0.09 x^2`` — the
ReLU replacement of the classifier head (counterpart of
``scale_imagenet_tpu/ops/poly.py:15``).  ``square_features`` restricts the
quadratic term to the leading features, as ``Classifier_scale_new``'s poly
branch does (``TT_FHE_SMALL.py:31-38`` squares ``x[:, :160]``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def polynome_act(x: torch.Tensor, alpha: float = 0.47, beta: float = 0.50,
                 gamma: float = 0.09,
                 square_features: int | None = None) -> torch.Tensor:
    if square_features is None or square_features >= x.shape[-1]:
        return alpha + beta * x + gamma * x * x
    # the quadratic term on the leading slice, linear elsewhere (the JAX
    # package's reading of a reference that broadcast-crashes here)
    sq = x[..., :square_features]
    return alpha + beta * x + gamma * F.pad(
        sq * sq, (0, x.shape[-1] - square_features))
