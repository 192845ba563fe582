"""GELU: the exact (erf) form and the polynomial ``fast_gelu`` (counterpart
of ``scale_imagenet_tpu/ops/gelu.py:27-69``).

The unfused eval path uses exact erf everywhere: it is the reference's
``F.gelu`` and the truth-table compiler's semantics.  ``fast_erf`` is the
plain version of the erf inside the fused pointwise kernel
(``csrc/fused_block.cu``), which must match it:

    erf(y) ~ sign(y) * a * P(2 a^2 / c^2 - 1),   a = min(|y|, c)

``P`` is the degree-16 Chebyshev fit of ``erf(y)/y`` on (0, c], c = 3.9192
(where f32 erf rounds to 1), evaluated by Horner in the input's dtype; the
17 coefficients are the JAX package's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_C = 3.9192
_POLY = (
    3.6081034995e-01, -1.8014451874e-01, 1.3410743171e-01,
    -1.0919577683e-01, 9.0629897258e-02, -7.3985296905e-02,
    5.8129466345e-02, -4.3540862328e-02, 3.0679596203e-02,
    -1.9648207814e-02, 1.1978128299e-02, -8.0814775912e-03,
    4.5950983811e-03, -1.0948765636e-03, 4.0678763248e-04,
    -9.2150733462e-04, 4.2988495543e-04,
)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def fast_erf(y: torch.Tensor) -> torch.Tensor:
    """Polynomial erf, |err| <= ~1e-6 in f32, exact saturation to +-1.
    Python-float constants round to ``y``'s dtype inside each op, as the
    JAX package's ``jnp.asarray(c, dtype)``."""
    a = y.abs().clamp(max=_C)
    t = (2.0 / (_C * _C)) * (a * a) - 1.0
    acc = torch.full_like(t, _POLY[-1])
    for p in _POLY[-2::-1]:
        acc = acc * t + p
    return torch.sign(y) * a * acc


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU via the polynomial erf: 0.5 x (1 + erf(x / sqrt(2)))."""
    e = fast_erf(x * _INV_SQRT2)
    return 0.5 * x * (1.0 + e)
