"""The bias regulariser, "cardinality bound decay" (counterpart of
``scale_imagenet_tpu/robust/regularizer.py``; netbin.py:786-864).

A loss over the ``(scale, bias)`` pairs that every ``stats_bn`` forward
shows to ``layers.norm.BN_OBSERVERS``, optionally weighted by the fan-in
(non-zero weight count) of the binarized layer before it.
"""

from __future__ import annotations

import contextlib

import torch


class _BNCollector:
    """Every ``stats_bn`` forward's ``(scale, bias)`` inside the context
    (the reference's ``on_bn_internals`` hook, netbin.py:811-833)."""

    def __init__(self):
        self.pairs = []

    def record(self, scale: torch.Tensor, bias: torch.Tensor) -> None:
        self.pairs.append((scale, bias))


@contextlib.contextmanager
def bn_internals_collector():
    from ..layers import norm

    c = _BNCollector()
    norm.BN_OBSERVERS.append(c)
    try:
        yield c
    finally:
        norm.BN_OBSERVERS.pop()


def bias_regularizer_loss(scale_bias_pairs, coeff: float, thresh: float,
                          layer_coeffs=None, fanin_weights=None):
    """``coeff * sum_l c_l * sum(relu(-bias / scale - thresh))``
    (netbin.py:812-833); ``fanin_weights``, per layer, weight each term
    and carry no gradient (the reference's ``detach_()``)."""
    total = torch.zeros(())
    for i, (scale, bias) in enumerate(scale_bias_pairs):
        c = 1.0 if layer_coeffs is None else layer_coeffs[i]
        if c == 0:
            continue
        cur = torch.relu(-bias / scale - thresh)
        if fanin_weights is not None and fanin_weights[i] is not None:
            cur = cur * fanin_weights[i].detach()
        total = total + c * cur.sum()
    return coeff * total


def fanin_nonzero(weight_bin: torch.Tensor) -> torch.Tensor:
    """The non-zero count per output unit of a binarized weight in the
    port's layouts, ``(out, in)`` or OIHW: every axis but the first
    (netbin.py:820-824)."""
    axes = tuple(range(1, weight_bin.dim()))
    return (weight_bin.abs() > 1e-4).to(weight_bin.dtype).sum(dim=axes)
