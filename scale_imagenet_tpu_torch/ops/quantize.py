"""k-bit uniform quantizers with the identity straight-through gradient
(counterpart of ``scale_imagenet_tpu/ops/quantize.py:19-45``).

The STE is the JAX package's stop-gradient form ``x + (f(x) - x)`` with the
bracket detached: the forward value is ``f(x)`` up to the rounding of that
sum, the backward the identity.  A ``clamp`` around a quantizer keeps its
own gradient (0 outside the range), as ``jnp.clip`` does.
``input_quantize`` comes with the families that use it (``ROADMAP.md``).
"""

from __future__ import annotations

import torch


def _ste(x: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    return x + (fx - x).detach()


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
    return coef * uniform_quantize(torch.clamp(x, 0.0, 1.0), a_bit)
