"""Classifier heads (counterpart of ``scale_imagenet_tpu/models/classifier.py``).

``Classifier_scale`` (``classifier.py:34``): Linear (no bias) -> BatchNorm1d
-> polynomial activation -> Linear(bias).  The TT_FHE family's copies of it
leave the polynomial out (``poly=False``).

``Classifier_scale_new`` (``classifier.py:42-62``, the TT_FHE
``_polyhead`` variant): the first ``non_lin`` features through Linear ->
BN -> the polynomial (squared on its first 160 features), the rest through
Linear -> BN, concatenated, then Linear(bias) -> BN.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..ops.poly import polynome_act


class ClassifierScale(nn.Module):
    """Reference names ``lin1``/``BN2``/``lin2``."""

    def __init__(self, fcsize: int, inter: int = 1000,
                 out_features: int = 1000, poly: bool = True):
        super().__init__()
        self.poly = poly
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
    if head.poly:
        y = polynome_act(y)
    return linear(y, head.lin2.weight, head.lin2.bias)


class ClassifierScaleNew(nn.Module):
    """Reference names ``lin1``/``BN1`` (the polynomial branch),
    ``lin2``/``BN2`` (the linear branch), ``linvf``/``BNvf``."""

    def __init__(self, fcsize: int, out_features: int = 10, inter: int = 50,
                 non_lin: int = 960):
        super().__init__()
        self.non_lin = non_lin
        self.lin1 = nn.Linear(non_lin, inter, bias=False)
        self.BN1 = nn.BatchNorm1d(inter)
        self.lin2 = nn.Linear(fcsize - non_lin, inter, bias=False)
        self.BN2 = nn.BatchNorm1d(inter)
        self.linvf = nn.Linear(2 * inter, out_features)
        self.BNvf = nn.BatchNorm1d(out_features)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return classifier_scale_new(self, x, stats)


def classifier_scale_new(head: ClassifierScaleNew, x: torch.Tensor,
                         stats: dict | None = None) -> torch.Tensor:
    x1, x2 = x[:, :head.non_lin], x[:, head.non_lin:]
    x1 = batch_norm(head.BN1, linear(x1, head.lin1.weight), stats)
    x2 = batch_norm(head.BN2, linear(x2, head.lin2.weight), stats)
    xf = torch.cat([polynome_act(x1, square_features=160), x2], dim=-1)
    return batch_norm(head.BNvf, linear(xf, head.linvf.weight,
                                        head.linvf.bias), stats)
