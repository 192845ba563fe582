"""TT_certif, the certified-robustness CIFAR model (counterpart of
``scale_imagenet_tpu/models/tt_certif.py:27-223``).

BN(3) -> BN(3) -> the dead-zone Heaviside (T = 0.07) on the pixels -> three
certif blocks -> Flatten -> Linear (or the abs-weight BinLinearPosv2 head,
``head="binpos_v2"``).  A certif block runs two Block_TT heads with dead
zones (T_block = 0.16): k = 3 pad 2 depthwise and k = 2 pad 1 at half the
groups, beside the input (identity at stride 1, AvgPool(2) at stride 2);
the reference's fix-ups crop or pad them (``_fixups``), a generic
reconcile brings them to the k = 2 head's size (``_to_size``), and they
are interleaved into a k = 2 fuse head with ``cpt`` = 3 groups.

The forward is stochastic, in eval too: its ``NoiseKey`` gives the draw
sites the JAX package's key order (``tt_certif.py:87-121,210-217``):
``split(key)`` is ``(noise.child(0), noise.child(1))``, the pixel site
the second; block i ``child(0).child(i)`` (``fold_in``), and its heads
``child(0)``, ``child(1)`` and ``child(2)`` of that (``split(·, 3)``).
The fuse heads are k = 2 with dead zones, so the fused pointwise kernel
never takes them.  ``tt_certif_interval`` (``tt_certif.py:226-320``)
bounds the logits over the clipped eps-ball and over every coin flip
(``robust/interval.py::interval_heaviside_noisy``): the certificate of
``--certify``.  Modules under the JAX trees' names.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..layers.linear import BinLinear, bin_linear, linear
from ..layers.norm import batch_norm, bn_scale_bias
from ..layers.pool import avg_pool, flatten, zero_pad2d
from ..ops.binarize import NoiseKey, binarize01_act
from ..ops.quantize import ste_round
from ..ops.weights import binarize_weights
from ..robust.interval import Interval, interval_avg_pool, \
    interval_batch_norm, interval_block_tt, interval_flatten, \
    interval_from_eps_ball, interval_heaviside_noisy, interval_linear, \
    interval_mono, interval_struct
from .block_tt import BlockTT, BlockTTConfig, block_tt, block_tt_out_size
from .multihead import channel_interleave
from .ttnet_cifar import blocks_of, nchw


@dataclasses.dataclass(frozen=True)
class CertifBlockConfig:
    in_planes: int
    out_planes: int
    stride: int = 1
    T: float = 0.0

    def head_cfgs(self) -> dict:
        """Groups [1, 2, None, 1] (``tt_certif.py:36``): head 1 k = 3
        pad 2, head 2 k = 2 pad 1; head 4 is the input."""
        return {
            1: BlockTTConfig(self.in_planes, self.in_planes, k=3, padding=2,
                             stride=self.stride, groupsici=self.in_planes,
                             T=self.T),
            2: BlockTTConfig(self.in_planes, self.in_planes, k=2, padding=1,
                             stride=self.stride,
                             groupsici=self.in_planes // 2, T=self.T),
        }

    @property
    def cpt(self) -> int:
        return 3

    def convf_cfg(self) -> BlockTTConfig:
        cin = self.cpt * self.in_planes
        return BlockTTConfig(cin, self.out_planes, k=2, padding=1, stride=1,
                             groupsici=cin // self.cpt, T=self.T)


def _fixups(xw: int, stride: int) -> tuple[tuple, bool]:
    """``(outputs cropped by a pixel at the bottom right, whether head 4
    is padded by one there)`` (``tt_certif.py:56``; at 32x32 stride 1 the
    reference's crop of head 4 cannot concatenate, and the JAX package
    pads it instead)."""
    if xw == 32 and stride == 1:
        return (1,), True
    if xw == 17:
        return (1,), False
    if xw in (8, 14, 20) or (stride == 2 and xw in (10, 6)):
        return (1, 4), False
    return (), False


def _to_size(a: torch.Tensor, target: int) -> torch.Tensor:
    """Cropped or zero-padded at the bottom right to ``target``."""
    cur = a.shape[2]
    if cur > target:
        return a[:, :, :target - cur, :target - cur]
    if cur < target:
        return zero_pad2d(a, (0, target - cur, 0, target - cur))
    return a


class CertifBlock(nn.Module):
    def __init__(self, cfg: CertifBlockConfig):
        super().__init__()
        self.cfg = cfg
        heads = cfg.head_cfgs()
        self.conv1 = BlockTT(heads[1])
        self.conv2 = BlockTT(heads[2])
        self.convf = BlockTT(cfg.convf_cfg())

    def forward(self, x: torch.Tensor, stats: dict | None = None,
                noise: NoiseKey | None = None) -> torch.Tensor:
        return certif_block(self, x, stats, noise)


def certif_block(block: CertifBlock, x: torch.Tensor,
                 stats: dict | None = None,
                 noise: NoiseKey | None = None) -> torch.Tensor:
    """``tt_certif.py:79``: the heads, head 4, the fix-ups, the reconcile
    to head 2's size, the interleave and the fuse head."""
    cfg = block.cfg
    keys = [None] * 3 if noise is None else [noise.child(i)
                                            for i in range(3)]
    out1 = block_tt(block.conv1, x, stats=stats, noise=keys[0])
    out2 = block_tt(block.conv2, x, stats=stats, noise=keys[1])
    out4 = x if cfg.stride == 1 else avg_pool(x, 2)
    crops, pad4 = _fixups(x.shape[3], cfg.stride)
    if 1 in crops:
        out1 = out1[:, :, :-1, :-1]
    if 4 in crops:
        out4 = out4[:, :, :-1, :-1]
    if pad4:
        out4 = zero_pad2d(out4, (0, 1, 0, 1))
    target = out2.shape[2]
    cat = torch.cat([_to_size(out1, target), out2, _to_size(out4, target)],
                    dim=1)
    return block_tt(block.convf, channel_interleave(cat, cfg.cpt),
                    stats=stats, noise=keys[2])


def certif_block_out_size(cfg: CertifBlockConfig, h: int,
                          w: int) -> tuple[int, int]:
    s2 = block_tt_out_size(cfg.head_cfgs()[2], h, w)
    return block_tt_out_size(cfg.convf_cfg(), *s2)


@dataclasses.dataclass(frozen=True)
class TTCertifConfig:
    # p = nfilter * tfilter must be divisible by 3 (the fuse head's
    # groups); the reference's own default (64) is not
    nfilter: int = 8
    tfilter: int = 6
    num_classes: int = 10
    image_size: int = 32
    T: float = 0.07
    T_block: float = 0.16
    head: str = "linear"      # or "binpos_v2" (BinLinearPosv2)

    @property
    def p(self) -> int:
        return self.nfilter * self.tfilter

    @property
    def stochastic(self) -> bool:
        """The forward draws coin flips (a dead zone somewhere)."""
        return self.T != 0.0 or self.T_block != 0.0

    def block_configs(self) -> list[CertifBlockConfig]:
        p = self.p
        in_planes, cfgs = 3, []
        for out_planes, stride in ((p, 1), (2 * p, 2), (4 * p, 2)):
            cfgs.append(CertifBlockConfig(in_planes, out_planes,
                                          stride=stride, T=self.T_block))
            in_planes = out_planes
        return cfgs

    @property
    def fcsize(self) -> int:
        h = w = self.image_size
        c = 3
        for cfg in self.block_configs():
            h, w = certif_block_out_size(cfg, h, w)
            c = cfg.out_planes
        return h * w * c


class TTCertif(nn.Module):
    def __init__(self, cfg: TTCertifConfig):
        super().__init__()
        self.cfg = cfg
        self.bn0 = nn.BatchNorm2d(3)
        self.bn1 = nn.BatchNorm2d(3)
        blocks = cfg.block_configs()
        self.n_blocks = len(blocks)
        for i, bcfg in enumerate(blocks):
            self.add_module(f"block{i}", CertifBlock(bcfg))
        self.fc = BinLinear(cfg.fcsize, cfg.num_classes) \
            if cfg.head == "binpos_v2" \
            else nn.Linear(cfg.fcsize, cfg.num_classes)

    def forward(self, x: torch.Tensor, stats: dict | None = None,
                noise: NoiseKey | None = None) -> torch.Tensor:
        return tt_certif_apply(self, x, stats, noise)


def tt_certif_apply(model: TTCertif, x: torch.Tensor,
                    stats: dict | None = None,
                    noise: NoiseKey | None = None) -> torch.Tensor:
    """NHWC images -> logits (``tt_certif.py:200``).  ``noise`` keys every
    dead zone; without it the forward fails, as the JAX one does without
    a key."""
    h = batch_norm(model.bn1, batch_norm(model.bn0, nchw(x, model), stats),
                   stats)
    root = None if noise is None else noise.child(0)
    h = binarize01_act(h, model.cfg.T,
                       None if noise is None else noise.child(1))
    for i, block in enumerate(blocks_of(model)):
        h = block(h, stats, None if root is None else root.child(i))
    return tt_certif_head(model, flatten(h))


def tt_certif_head(model: TTCertif, h: torch.Tensor) -> torch.Tensor:
    """The flattened features -> logits."""
    if model.cfg.head == "binpos_v2":
        return bin_linear(h, model.fc, abs_weight=True)
    return linear(h, model.fc.weight, model.fc.bias)


# ---------------------------------------------------------------------------
# certified robustness: the interval forward to the logits


def _interval_certif_block(block: CertifBlock, iv: Interval) -> Interval:
    """``certif_block`` on an interval; the heads share the input's loss,
    so only each head's own contribution is summed."""
    cfg = block.cfg
    in_loss = iv.loss
    out1 = interval_block_tt(block.conv1, iv)
    out2 = interval_block_tt(block.conv2, iv)
    out4 = iv if cfg.stride == 1 else interval_avg_pool(iv, 2)
    crops, pad4 = _fixups(iv.vmin.shape[3], cfg.stride)
    if 1 in crops:
        out1 = interval_struct(out1, lambda v: v[:, :, :-1, :-1])
    if 4 in crops:
        out4 = interval_struct(out4, lambda v: v[:, :, :-1, :-1])
    if pad4:
        out4 = interval_struct(out4, lambda v: zero_pad2d(v, (0, 1, 0, 1)))
    target = out2.vmin.shape[2]
    out1 = interval_struct(out1, lambda v: _to_size(v, target))
    out4 = interval_struct(out4, lambda v: _to_size(v, target))
    cat = Interval(
        torch.cat([out1.vmin, out2.vmin, out4.vmin], dim=1),
        torch.cat([out1.vmax, out2.vmax, out4.vmax], dim=1),
        in_loss + (out1.loss - in_loss) + (out2.loss - in_loss)
        + (out4.loss - in_loss))
    cat = interval_struct(cat, lambda v: channel_interleave(v, cfg.cpt))
    return interval_block_tt(block.convf, cat)


def tt_certif_interval(model: TTCertif, x: torch.Tensor, eps,
                       inputs_min=0.0, inputs_max=1.0) -> Interval:
    """Sound logit bounds for every input in the clipped eps-ball around
    the NHWC images ``x`` and every dead-zone draw (the noisy Heaviside is
    bounded, not sampled): the logits ``Interval``."""
    iv = interval_from_eps_ball(x, eps, inputs_min, inputs_max)
    iv = interval_struct(iv, lambda v: nchw(v, model))
    iv = interval_batch_norm(iv, *bn_scale_bias(model.bn0))
    iv = interval_batch_norm(iv, *bn_scale_bias(model.bn1))
    iv = interval_heaviside_noisy(iv, model.cfg.T)
    for block in blocks_of(model):
        iv = _interval_certif_block(block, iv)
    return tt_certif_interval_head(model, interval_flatten(iv))


def tt_certif_interval_head(model: TTCertif, iv: Interval) -> Interval:
    """The flattened feature bounds -> the logits'."""
    fc = model.fc
    if model.cfg.head == "binpos_v2":
        w = binarize_weights("ternary_mask", fc.weight, fc.weight_mask).abs()
        return interval_mono(interval_linear(iv, w, linear), ste_round)
    return interval_linear(iv, fc.weight, linear, bias=fc.bias)


def tt_certif_interval_logits(model: TTCertif, x: torch.Tensor, eps,
                              inputs_min=0.0, inputs_max=1.0) -> Interval:
    return tt_certif_interval(model, x, eps, inputs_min, inputs_max)


def tt_certif_interval_loss(model: TTCertif, x: torch.Tensor, eps,
                            inputs_min=0.0,
                            inputs_max=1.0) -> torch.Tensor:
    """The activation-stability loss (``rsloss`` at every Heaviside) of the
    interval forward: ``--abstract_eps`` on this model."""
    return tt_certif_interval(model, x, eps, inputs_min, inputs_max).loss
