"""Heaviside {0,1} activation with its straight-through backward
(counterpart of ``scale_imagenet_tpu/ops/binarize.py:27-63``).

Forward: ``(x >= 0)`` in {0, 1}, in ``x``'s dtype: the deterministic
``T == 0`` form every shipped ImageNet model uses.  Backward: the
surrogate ``g * (1 - tanh(x * s)^2)`` with ``s =
numerics.bingrad_soft_tanh_scale`` (times the models' ``grad_scale`` of 1,
as in the JAX package), or the hardtanh mask ``g * (|x| <= 1)`` when that
scale is ``None``; the surrogate is computed in ``x``'s dtype (bf16
under ``--amp``).  Where no gradient is wanted (eval, serving, the
truth-table compiler) the forward runs as one comparison, outside autograd.
The noisy dead-zone (T != 0) comes with the families that use it
(``ROADMAP.md``).  ``bireal_act`` is the Bi-Real sign stem activation of the
TT_FHE family (``binarize.py:130``), forward only: its surrogate backward
comes with FHE training (``ROADMAP.md``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import numerics


class _Heaviside01(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: float | None) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.scale = scale
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        if ctx.scale is None:
            return (x.abs() <= 1).to(g.dtype) * g, None
        t = torch.tanh(x * ctx.scale)
        return ((1.0 - t * t) * g).to(g.dtype), None


def heaviside01(x: torch.Tensor) -> torch.Tensor:
    """``(x >= 0)`` in {0, 1}, in ``x``'s dtype, with the straight-through
    backward when ``x`` carries a gradient."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return (x >= 0).to(x.dtype)
    s = numerics.bingrad_soft_tanh_scale
    if s is not None:
        # rounded to x's dtype first, as the JAX package's
        # ``jnp.asarray(grad_scale * s, x.dtype)``
        s = float(torch.tensor(s, dtype=x.dtype))
    return _Heaviside01.apply(x, s)


def binarize01_act(x: torch.Tensor, T: float = 0.0) -> torch.Tensor:
    """The user-facing activation at ``T == 0`` (deterministic Heaviside)."""
    if T != 0.0:
        raise NotImplementedError(
            "the noisy dead-zone Heaviside (T != 0) comes with the families "
            "that use it; see ROADMAP.md queue A")
    return heaviside01(x)


class Binarize01Act(nn.Module):
    """Module form with the reference's ``grad_scale`` buffer, so reference
    state dicts load with ``strict=True``.  The forward functions use the
    JAX package's default scale of 1, as its models do, and never read the
    buffer."""

    def __init__(self):
        super().__init__()
        self.register_buffer("grad_scale", torch.tensor(1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return heaviside01(x)


def bireal_act(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """``alpha * (sign((x - beta) / alpha) + beta)`` (``BinaryActivation``,
    ``binarize.py:130``), in ``x``'s dtype."""
    return alpha * (torch.sign((x - beta) / alpha) + beta)


class BinaryActivation(nn.Module):
    """The Bi-Real stem activation with its learnable ``alpha_a``/``beta_a``
    (reference names; 1 and 0 at init, 0-d as the JAX exporter writes
    them)."""

    def __init__(self):
        super().__init__()
        self.alpha_a = nn.Parameter(torch.tensor(1.0))
        self.beta_a = nn.Parameter(torch.tensor(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bireal_act(x, self.alpha_a, self.beta_a)
