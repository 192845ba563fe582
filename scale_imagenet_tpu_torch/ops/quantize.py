"""k-bit uniform quantizers with the identity straight-through gradient
(counterpart of ``scale_imagenet_tpu/ops/quantize.py:19-45``).

The STE is the JAX package's stop-gradient form ``x + (f(x) - x)`` with the
bracket detached: the forward value is ``f(x)`` up to the rounding of that
sum, the backward the identity.  The clip around a quantizer keeps its
own gradient, as ``jnp.clip``'s: 0 outside the range, 1 inside and 1/2 on
its ends (``clip``; ``torch.clamp`` gives 1 there, and the ends are hit
exactly where a ReLU feeds a quantizer, as in the DoReFa ResNets).
"""

from __future__ import annotations

import torch


def _ste(x: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    return x + (fx - x).detach()


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient is
    split in half where ``x`` equals an end."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with the identity gradient (``quantize.py:23``)."""
    return _ste(x, torch.round(x))


def uniform_quantize(x: torch.Tensor, k: int) -> torch.Tensor:
    """``round(x * (2^k - 1)) / (2^k - 1)`` with the identity gradient;
    ``k == 32`` is the identity, ``k == 1`` the sign (``quantize.py:28``)."""
    if k == 32:
        return x
    if k == 1:
        return _ste(x, torch.sign(x))
    n = float(2 ** k - 1)
    return _ste(x, torch.round(x * n) / n)


def activation_quantize(x: torch.Tensor, a_bit: int = 2) -> torch.Tensor:
    """The k-bit activation quantizer scaled to the integers
    ``0 .. 2^k - 1`` (``activation_quantize_fn2``, ``quantize.py:39``)."""
    if a_bit == 32:
        return x
    coef = float(2 ** a_bit - 1)
    return coef * uniform_quantize(clip(x, 0.0, 1.0), a_bit)


def input_quantize(x: torch.Tensor, step: float) -> torch.Tensor:
    """Inputs in [0, 1] to multiples of ``step``, the round straight-through
    (``InputQuantizer``, ``quantize.py:48``)."""
    return ste_round(x / step) * step
