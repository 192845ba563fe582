"""``Classifier_scale`` head (counterpart of ``scale_imagenet_tpu/models/classifier.py:34``):
Linear (no bias) -> BatchNorm1d -> polynomial activation -> Linear(bias).
The ``Classifier_scale_new`` split head comes with the FHE families."""

from __future__ import annotations

import torch
from torch import nn

from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..ops.poly import polynome_act


class ClassifierScale(nn.Module):
    """Reference names ``lin1``/``BN2``/``lin2``."""

    def __init__(self, fcsize: int, inter: int = 1000,
                 out_features: int = 1000):
        super().__init__()
        self.lin1 = nn.Linear(fcsize, inter, bias=False)
        self.BN2 = nn.BatchNorm1d(inter)
        self.lin2 = nn.Linear(inter, out_features)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return classifier_scale(self, x, stats)


def classifier_scale(head: ClassifierScale, x: torch.Tensor,
                     stats: dict | None = None) -> torch.Tensor:
    """Eval, or training when ``stats`` is given (``layers/norm.py``)."""
    # lin1 has a bias after BN folding (``convert/bn_fold.py``)
    y = batch_norm(head.BN2, linear(x, head.lin1.weight, head.lin1.bias),
                   stats)
    return linear(polynome_act(y), head.lin2.weight, head.lin2.bias)
