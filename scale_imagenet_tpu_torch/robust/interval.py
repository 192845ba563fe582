"""Interval-arithmetic abstract interpretation (counterpart of
``scale_imagenet_tpu/robust/interval.py``).

Propagates ``[vmin, vmax]`` bounds through the network by +/- weight
decomposition and accumulates the activation-stability loss
``sum(1 - tanh(1 + vmin * vmax))`` at every Heaviside (the reference's
``AbstractTensor``, netbin.py:84-129, 222-230).  Bounds are NCHW inside the
models, as their activations are; ``interval_from_eps_ball`` takes the
NHWC images the forwards take, so a per-channel radius broadcasts on the
last axis, as in the JAX package.  Bias, BN scale and BN shift broadcast on
the channel axis (1 of a 4-D bound, the last of a 2-D one).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..layers.conv import conv2d
from ..layers.linear import bias_from_bin_weight
from ..layers.norm import bn_scale_bias
from ..layers.pool import avg_pool, constant_pad2d, flatten
from ..ops.binarize import heaviside01, rsloss
from ..ops.gelu import gelu

LOSS_LAYER_DECAY = 1.0   # netbin.py:90-91


@dataclasses.dataclass
class Interval:
    vmin: torch.Tensor
    vmax: torch.Tensor
    loss: torch.Tensor

    @property
    def shape(self):
        return self.vmin.shape


def _channels(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over ``x``."""
    return v.view(1, -1, 1, 1) if x.dim() == 4 else v


def _bound(x: torch.Tensor, b) -> torch.Tensor:
    return torch.as_tensor(b, dtype=x.dtype, device=x.device)


def interval_from_eps_ball(x: torch.Tensor, eps, inputs_min=0.0,
                           inputs_max=1.0) -> Interval:
    """``[max(x - eps, lo), min(x + eps, hi)]`` (netbin.py:734-738); each
    of ``eps``, ``inputs_min`` and ``inputs_max`` a number or a tensor
    that broadcasts over ``x``."""
    eps = _bound(x, eps)
    return Interval(torch.maximum(x - eps, _bound(x, inputs_min)),
                    torch.minimum(x + eps, _bound(x, inputs_max)),
                    torch.zeros((), dtype=x.dtype, device=x.device))


def interval_linear(iv: Interval, w: torch.Tensor, func,
                    bias: torch.Tensor | None = None) -> Interval:
    """A linear ``func(x, w)`` by the +/- decomposition of ``w``
    (netbin.py:100-109); ``bias`` shifts both bounds."""
    wpos = torch.relu(w)
    wneg = w - wpos
    vmin = func(iv.vmin, wpos) + func(iv.vmax, wneg)
    vmax = func(iv.vmax, wpos) + func(iv.vmin, wneg)
    if bias is not None:
        vmin = vmin + _channels(bias, vmin)
        vmax = vmax + _channels(bias, vmax)
    return Interval(torch.minimum(vmin, vmax), torch.maximum(vmin, vmax),
                    iv.loss)


def interval_mono(iv: Interval, func) -> Interval:
    """A non-decreasing elementwise function (netbin.py:111-113)."""
    return Interval(func(iv.vmin), func(iv.vmax), iv.loss)


def interval_conv2d(iv: Interval, weight: torch.Tensor, stride=1,
                    padding=0, groups: int = 1,
                    bias: torch.Tensor | None = None) -> Interval:
    """The (grouped) conv of OIHW ``weight``; ``bias`` a conv's own, which
    the JAX models add after the call."""
    return interval_linear(
        iv, weight, lambda x, w: conv2d(x, w, None, stride, padding, groups),
        bias)


def interval_bin_linear_pos(iv: Interval,
                            weight_bin: torch.Tensor) -> Interval:
    """BinLinearPos: the linear part by decomposition of the ``(out, in)``
    binarized weight, its NOT-gate bias added to both bounds
    (netbin.py:529-535)."""
    return interval_linear(iv, weight_bin, F.linear,
                           bias=bias_from_bin_weight(weight_bin))


def interval_batch_norm(iv: Interval, scale: torch.Tensor,
                        bias: torch.Tensor) -> Interval:
    """Eval BN as the affine ``x * scale + bias``; negative scales swap the
    bounds through the same decomposition (netbin.py:604-609)."""
    return interval_linear(iv, scale, lambda x, s: x * _channels(s, x),
                           bias=bias)


def interval_heaviside(iv: Interval) -> Interval:
    """The Heaviside on both bounds (straight-through, the models' grad
    scale of 1), the ``rsloss`` stability term added (netbin.py:225-230).
    It bypasses ``binarize01_act``: no observer sees an interval."""
    loss = rsloss(iv.vmin, iv.vmax) + iv.loss * LOSS_LAYER_DECAY
    return Interval(heaviside01(iv.vmin), heaviside01(iv.vmax), loss)


def interval_flatten(iv: Interval) -> Interval:
    return Interval(flatten(iv.vmin), flatten(iv.vmax), iv.loss)


def interval_struct(iv: Interval, fn) -> Interval:
    """A structural op (moves, zero-pads or crops elements, no arithmetic on
    them) on both bounds; a pad inserts [0, 0] intervals."""
    return Interval(fn(iv.vmin), fn(iv.vmax), iv.loss)


def interval_avg_pool(iv: Interval, k: int) -> Interval:
    """Average pooling is a nonnegative linear map: both bounds."""
    return Interval(avg_pool(iv.vmin, k), avg_pool(iv.vmax, k), iv.loss)


def _gelu_argmin() -> tuple[float, float]:
    """The minimum of exact GELU ``x * Phi(x)``: Newton on ``Phi(x) +
    x * phi(x) = 0`` in float64, once at import (``interval.py:128``)."""
    x = -0.75
    for _ in range(40):
        phi = math.exp(-x * x / 2) / math.sqrt(2 * math.pi)
        Phi = 0.5 * (1 + math.erf(x / math.sqrt(2)))
        f = Phi + x * phi
        fp = 2 * phi - x * x * phi
        x -= f / fp
    Phi = 0.5 * (1 + math.erf(x / math.sqrt(2)))
    return x, x * Phi


GELU_XMIN, GELU_MIN = _gelu_argmin()


def interval_gelu(iv: Interval) -> Interval:
    """Exact (erf) GELU on an interval.  GELU falls left of its minimum
    ``x* ~ -0.7518`` and rises right of it, so the maximum lies at an end
    and the minimum is ``g(x*)`` where the interval straddles ``x*``, else
    at an end."""
    lo_g, hi_g = gelu(iv.vmin), gelu(iv.vmax)
    vmax = torch.maximum(lo_g, hi_g)
    vmin = torch.minimum(lo_g, hi_g)
    straddles = (iv.vmin < GELU_XMIN) & (iv.vmax > GELU_XMIN)
    vmin = torch.where(straddles, _bound(vmin, GELU_MIN), vmin)
    return Interval(vmin, vmax, iv.loss)


def interval_heaviside_noisy(iv: Interval, T: float) -> Interval:
    """The dead-zone Heaviside on an interval, sound over the input range
    and every coin: 1 is certain where ``vmin >= T/2``, 0 where ``vmax <
    -T/2``; the same stability loss as ``interval_heaviside``."""
    if T == 0.0:
        return interval_heaviside(iv)
    # T / 2 rounded to the bounds' dtype, as ``jnp.asarray(T / 2, dtype)``
    half = float(torch.tensor(T / 2, dtype=iv.vmin.dtype))
    loss = rsloss(iv.vmin, iv.vmax) + iv.loss * LOSS_LAYER_DECAY
    return Interval(heaviside01(iv.vmin - half), heaviside01(iv.vmax + half),
                    loss)


def interval_block_tt(block, iv: Interval) -> Interval:
    """A ``BlockTT`` (``models/block_tt.py``) on an interval, eval
    semantics: pad -> grouped conv -> BN -> GELU -> 1x1 grouped conv -> BN
    -> the dead-zone Heaviside (ReLU when ``last``)."""
    cfg = block.cfg
    if cfg.padding != 0:
        iv = interval_struct(iv, lambda v: constant_pad2d(v, cfg.padding))
    iv = interval_conv2d(iv, block.conv1.weight, stride=cfg.stride,
                         groups=cfg.groupsici, bias=block.conv1.bias)
    iv = interval_batch_norm(iv, *bn_scale_bias(block.bn1))
    iv = interval_gelu(iv)
    iv = interval_conv2d(iv, block.conv2.weight, groups=cfg.groupsici,
                         bias=block.conv2.bias)
    iv = interval_batch_norm(iv, *bn_scale_bias(block.bn2))
    if cfg.last:
        return interval_mono(iv, torch.relu)
    return interval_heaviside_noisy(iv, cfg.T)


def certified_mask(iv_logits: Interval, preds: torch.Tensor) -> torch.Tensor:
    """Per image: the prediction cannot change within the input region iff
    the predicted class's lower logit bound beats every other class's upper
    bound."""
    onehot = F.one_hot(preds, iv_logits.vmin.shape[-1]).bool()
    zero = torch.zeros((), dtype=iv_logits.vmin.dtype,
                       device=iv_logits.vmin.device)
    pred_lo = torch.where(onehot, iv_logits.vmin, zero).sum(-1)
    others_hi = torch.where(onehot, zero - math.inf,
                            iv_logits.vmax).amax(-1)
    return pred_lo > others_hi
