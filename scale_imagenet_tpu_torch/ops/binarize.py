"""Heaviside {0,1} activations with their straight-through backward
(counterpart of ``scale_imagenet_tpu/ops/binarize.py:27-170``).

Forward: ``(x >= 0)`` in {0, 1}, in ``x``'s dtype: the deterministic
``T == 0`` form every shipped ImageNet model uses.  Backward: the
surrogate ``g * (1 - tanh(x * s)^2)`` with ``s =
numerics.bingrad_soft_tanh_scale`` (times the models' ``grad_scale`` of 1,
as in the JAX package), or the hardtanh mask ``g * (|x| <= 1)`` when that
scale is ``None``; the surrogate is computed in ``x``'s dtype (bf16
under ``--amp``).  Where no gradient is wanted (eval, serving, the
truth-table compiler) the forward runs as one comparison, outside autograd.

The noisy dead-zone form (``T != 0``, ``binarize.py:67-103``) rounds the
outputs in ``[-T/2, T/2)`` by a fair coin, in eval too.  As in the JAX
package the core takes the coin flips as a tensor
(``heaviside01_noisy``); they are drawn apart from it, from an explicit
``torch.Generator`` (``dead_zone_noise``).  A ``NoiseKey`` says where:
one seed a draw site, each child key's seed derived from its parent's and
the site's index, as the JAX package folds and splits its PRNG keys.
torch's generator cannot give JAX's bits; the tests replay JAX's draws
through the same ``draw`` hook.

``binarize01_act`` shows its input to the innermost of
``ACTIVATION_OBSERVERS`` (``binarize.py:152-164``), the hook of the
robust forwards (``robust/collect.py``): every model reaches its
Heaviside through it, as every JAX model does, while the LUT, gate and
fused-kernel forwards compute their bits without it.  ``rsloss`` is the
activation-stability loss those forwards accumulate.

``bireal_act`` is the Bi-Real sign stem activation of the TT_FHE family
(``binarize.py:130``) with its piecewise-polynomial surrogate backward
(``binarize.py:108-127``), so that ``alpha``, ``beta`` and what lies
before it train.
"""

from __future__ import annotations

import hashlib

import torch
from torch import nn

from ..config import numerics


def _surrogate(x: torch.Tensor, g: torch.Tensor, scale: float | None):
    """The STE backward of every Heaviside form (``binarize.py:27``)."""
    if scale is None:
        return (x.abs() <= 1).to(g.dtype) * g
    t = torch.tanh(x * scale)
    return ((1.0 - t * t) * g).to(g.dtype)


def _scale(x: torch.Tensor) -> float | None:
    s = numerics.bingrad_soft_tanh_scale
    if s is not None:
        # rounded to x's dtype first, as the JAX package's
        # ``jnp.asarray(grad_scale * s, x.dtype)``
        s = float(torch.tensor(s, dtype=x.dtype))
    return s


def _wants_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


class _Heaviside01(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: float | None) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.scale = scale
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return _surrogate(x, g, ctx.scale), None


def heaviside01(x: torch.Tensor) -> torch.Tensor:
    """``(x >= 0)`` in {0, 1}, in ``x``'s dtype, with the straight-through
    backward when ``x`` carries a gradient."""
    if not _wants_grad(x):
        return (x >= 0).to(x.dtype)
    return _Heaviside01.apply(x, _scale(x))


def _noisy_forward(x: torch.Tensor, noise: torch.Tensor,
                   half_t: float) -> torch.Tensor:
    # 1[x >= T/2] + 1[-T/2 <= x < T/2] * coin (``binarize.py:67-72``)
    ones = (x >= half_t).to(x.dtype)
    dead = (x < half_t).to(x.dtype) - (x < -half_t).to(x.dtype)
    return ones + dead * noise.to(x.dtype)


class _Heaviside01Noisy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, noise, half_t: float, scale: float | None):
        ctx.save_for_backward(x)
        ctx.scale = scale
        return _noisy_forward(x, noise, half_t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return _surrogate(x, g, ctx.scale), None, None, None


def heaviside01_noisy(x: torch.Tensor, T: float,
                      noise: torch.Tensor) -> torch.Tensor:
    """The dead-zone Heaviside: ``x >= T/2`` gives 1, ``x < -T/2`` gives 0,
    and in between the output is ``noise``, the {0,1} coin flips of this
    site (``x``'s shape); the backward is the Heaviside's STE."""
    if noise.shape != x.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for an "
                         f"input of shape {tuple(x.shape)}")
    # T / 2 rounded to x's dtype, as ``jnp.asarray(T / 2, x.dtype)``
    half_t = float(torch.tensor(T / 2, dtype=x.dtype))
    if not _wants_grad(x):
        return _noisy_forward(x, noise, half_t)
    return _Heaviside01Noisy.apply(x, noise, half_t, _scale(x))


def dead_zone_noise(x: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """Fair coin flips in {0, 1} of ``x``'s shape, dtype and device, drawn
    from ``generator`` (which lives on ``x``'s device)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return (u < 0.5).to(x.dtype)


def _derive(seed: int, index) -> int:
    h = hashlib.blake2b(f"{seed}/{index}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class NoiseKey:
    """The seed of one draw site, and the keys below it: ``child(i)`` is
    the key of sub-site ``i`` (a block, a head), its seed a hash of this
    one's and ``i``.  ``draw(x)`` gives the coin flips of this site, from a
    ``torch.Generator`` on ``x``'s device seeded with the key's seed: the
    same key gives the same flips, wherever it is asked."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def child(self, index) -> "NoiseKey":
        return type(self)(_derive(self.seed, index))

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=x.device).manual_seed(self.seed)
        return dead_zone_noise(x, gen)

    def __repr__(self) -> str:
        return f"NoiseKey({self.seed})"


# observers of the pre-activation values: ``record(x)`` of the innermost
# is called at every ``binarize01_act`` (``robust/collect.py`` registers)
ACTIVATION_OBSERVERS: list = []


def binarize01_act(x: torch.Tensor, T: float = 0.0,
                   noise: NoiseKey | None = None) -> torch.Tensor:
    """The user-facing activation (``binarize.py:155``): deterministic when
    ``T == 0``, else the dead-zone form with its flips drawn from
    ``noise`` (anything with ``draw(x)``), which it then needs, as the JAX
    function needs its key."""
    if ACTIVATION_OBSERVERS:
        ACTIVATION_OBSERVERS[-1].record(x)
    if T == 0.0:
        return heaviside01(x)
    if noise is None:
        raise ValueError("binarize01_act with T != 0 needs a noise key "
                         "(the port's NoiseKey, the JAX package's PRNG "
                         "key)")
    return heaviside01_noisy(x, T, noise.draw(x))


def rsloss(vmin: torch.Tensor, vmax: torch.Tensor) -> torch.Tensor:
    """The activation-stability loss ``sum(1 - tanh(1 + vmin * vmax))``
    (``binarize.py:172``)."""
    return torch.sum(1.0 - torch.tanh(1.0 + vmin * vmax))


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


def _bireal_surrogate(y: torch.Tensor) -> torch.Tensor:
    """d/dy of the Bi-Real clip function, piecewise in y < -1, [-1, 0),
    [0, 1) and >= 1: 0, 2y + 2, -2y + 2, 0 (``binarize.py:113-122``)."""
    zero = torch.zeros_like(y)
    return torch.where(y < -1.0, zero, torch.where(
        y < 0.0, 2.0 * y + 2.0, torch.where(y < 1.0, -2.0 * y + 2.0, zero)))


class _BirealSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(y)
        return torch.sign(y)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (y,) = ctx.saved_tensors
        return _bireal_surrogate(y).to(g.dtype) * g


def bireal_act(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """``alpha * (sign((x - beta) / alpha) + beta)`` (``BinaryActivation``,
    ``binarize.py:130``), in ``x``'s dtype; the sign's backward is the
    Bi-Real surrogate, and ``alpha``/``beta`` get their gradients through
    the affine around it and through the surrogate, as autograd composes
    them in the JAX package."""
    y = (x - beta) / alpha
    s = _BirealSign.apply(y) if _wants_grad(y) else torch.sign(y)
    return alpha * (s + beta)


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
