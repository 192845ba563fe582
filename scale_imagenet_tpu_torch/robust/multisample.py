"""Multi-sample perturbation forward (counterpart of
``scale_imagenet_tpu/robust/multisample.py``).

The reference packs ``(x_adv, clamp(x - delta), clamp(x + delta))``, with
``delta`` a random sign pattern in {-eps, +eps}, as one ``(3 N, ...)``
batch, runs the normal forward and accumulates at each Heaviside the
stability loss between the last two samples (netbin.py:131-181, 231-237,
710-724).  The signs are fair coins from a ``NoiseKey``
(``ops/binarize.py``): the same key gives the same pattern, on the device
of the images.
"""

from __future__ import annotations

import torch

from ..ops.binarize import binarize01_act, rsloss

LOSS_LAYER_DECAY = 1.0


def multi_sample_pack(x: torch.Tensor, x_adv: torch.Tensor, eps, key,
                      inputs_min=0.0, inputs_max=1.0):
    """``(k = 3, data)``: ``[x_adv, x - delta, x + delta]`` clamped to
    ``[inputs_min, inputs_max]``, ``delta = +-eps`` with the sign drawn by
    ``key.draw(x)`` (netbin.py:716-723).  The bounds may be per-channel
    tensors that broadcast over the NHWC images."""
    sign = key.draw(x)
    delta = sign * (2 * eps) - eps
    lo = torch.as_tensor(inputs_min, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(inputs_max, dtype=x.dtype, device=x.device)
    low = torch.maximum(x - delta, lo)
    high = torch.minimum(x + delta, hi)
    return 3, torch.cat([x_adv, low, high], dim=0)


def multi_sample_heaviside(x: torch.Tensor, k: int, loss: torch.Tensor,
                           T: float = 0.0, noise=None):
    """The Heaviside over the packed batch, and ``loss`` with the
    ``rsloss`` between the last two samples added (netbin.py:231-237):
    ``(out, new_loss)``."""
    rv = x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
    extra = rsloss(rv[-1], rv[-2])
    return binarize01_act(x, T, noise), loss * LOSS_LAYER_DECAY + extra


def multi_sample_unpack_natural(y: torch.Tensor, k: int) -> torch.Tensor:
    """The first sample group: the natural (or adversarial) images
    (netbin.py:723-724)."""
    return y.reshape((k, y.shape[0] // k) + tuple(y.shape[1:]))[0]
