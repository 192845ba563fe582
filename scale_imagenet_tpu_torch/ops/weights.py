"""Weight binarizers (counterpart of ``scale_imagenet_tpu/ops/weights.py``).

* ``binarize01_weight_noscale``: forward ``(w >= 0)``; backward the
  incoming gradient plus ``weight_decay * out``;
* ``ternary_weight``: forward ``sign(w) * (|w| >= 0.005)``, the same
  backward;
* ``ternary_weight_with_mask``: ``sign(w)`` with the identity gradient,
  multiplied by a learned 0/1 mask (``binarize_weights``);
* ``identity_weight``: the float weight (optionally masked);
* ``quant3_weight``: 7 steps of 0.032 / 7 over [-0.016, 0.016], integers
  in [-3, 3], with the identity gradient.

The two binarizers whose JAX form is a ``custom_vjp`` are
``torch.autograd.Function``s here; the others are the stop-gradient STE of
``ops/quantize.py``.
"""

from __future__ import annotations

import torch

from ..config import numerics
from .quantize import _ste


def _resolve_decay(weight_decay: float | None) -> float:
    return numerics.weight_decay if weight_decay is None else weight_decay


class _DecayInGradBin01(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w: torch.Tensor, weight_decay: float) -> torch.Tensor:
        out = (w >= 0).to(w.dtype)
        ctx.save_for_backward(out)
        ctx.weight_decay = weight_decay
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (out,) = ctx.saved_tensors
        return (g + out * ctx.weight_decay).to(g.dtype), None


class _DecayInGradTernary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w: torch.Tensor, weight_decay: float) -> torch.Tensor:
        out = torch.sign(w) * (w.abs() >= 0.005).to(w.dtype)
        ctx.save_for_backward(out)
        ctx.weight_decay = weight_decay
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (out,) = ctx.saved_tensors
        return (g + out * ctx.weight_decay).to(g.dtype), None


def binarize01_weight_noscale(w: torch.Tensor,
                              weight_decay: float | None = None) \
        -> torch.Tensor:
    return _DecayInGradBin01.apply(w, _resolve_decay(weight_decay))


def ternary_weight(w: torch.Tensor,
                   weight_decay: float | None = None) -> torch.Tensor:
    return _DecayInGradTernary.apply(w, _resolve_decay(weight_decay))


def ternary_weight_with_mask(w: torch.Tensor) -> torch.Tensor:
    """``sign(w)`` with the identity gradient (the mask applies apart)."""
    return _ste(w, torch.sign(w))


def identity_weight(w: torch.Tensor) -> torch.Tensor:
    return w


def quant3_weight(w: torch.Tensor) -> torch.Tensor:
    """The 7-step quantization to the integers in [-3, 3] with the
    identity gradient (``weights.py:87``)."""
    qmin, qmax = -0.016, 0.016
    step = (qmax - qmin) / 7
    q = torch.clamp(torch.floor((w - qmin) / step) - 3, -3, 3)
    return _ste(w, q)


WEIGHT_BINARIZERS = {
    "ternary_mask": ternary_weight_with_mask,
    "quant3_mask": quant3_weight,
    "identity": identity_weight,
    "ternary": ternary_weight,
    "quant3": quant3_weight,
    "bin01": binarize01_weight_noscale,
}

# the binarizers combined with a learned 0/1 ``weight_mask``
_MASKED = {"ternary_mask", "quant3_mask", "identity"}


def uses_weight_mask(kind: str) -> bool:
    return kind in _MASKED


def binarize_weights(kind: str, weight: torch.Tensor,
                     weight_mask: torch.Tensor | None = None,
                     weight_decay: float | None = None) -> torch.Tensor:
    """The selected binarizer; the masked kinds multiply by the binarized
    ``weight_mask`` (``weights.py:115``)."""
    fn = WEIGHT_BINARIZERS[kind]
    if uses_weight_mask(kind):
        if weight_mask is None:
            raise ValueError(f"binarizer {kind!r} requires a weight_mask")
        return fn(weight) * binarize01_weight_noscale(weight_mask,
                                                      weight_decay)
    return fn(weight)


def init_weight_mask(shape, generator: torch.Generator,
                     dtype=torch.float32) -> torch.Tensor:
    """``|N(0, weight_mask_std)|``, drawn on the CPU from ``generator``."""
    return (torch.randn(shape, generator=generator, dtype=dtype)
            * numerics.weight_mask_std).abs()
