"""The multi-head TTnet block (counterpart of ``scale_imagenet_tpu/models/multihead.py``).

Three Block_TT heads and a pooled raw-input head over the same input, shape-
reconciled by the reference's pad table (``FIXUP_RULES``), channel-
interleaved and fused by a 1x1 Block_TT.  The pad *corner* (top-left for
the first 56x56 stage, bottom-right elsewhere) is part of the trained
models' semantics.  NCHW inside.  The tables are those of the
ttnet_imagenet variants (``v2small``, its VGG-stem row, ``v2``) and of the
TT_FHE family (``fhe_v3``, ``fhe_v2``, ``fhe_valexnet``).

A block whose heads have a dead zone (``T != 0``; ``TT_FHE_small``) takes a
``NoiseKey`` and gives each draw site the child key of the JAX package's
slot (``multihead.py:297-341``): heads 1-3 their index, 4 the pooled raw
input and 5 head 3's re-pool at stride 2, 6 the fuse head.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..layers.pool import avg_pool, zero_pad2d
from ..ops.binarize import Binarize01Act, NoiseKey, binarize01_act
from .block_tt import BlockTT, BlockTTConfig, block_tt, block_tt_out_size

# torch ZeroPad2d tuples: (left, right, top, bottom)
_PAD0 = (1, 0, 1, 0)    # +1 top-left
_PAD2 = (0, 1, 0, 1)    # +1 bottom-right
_PAD3 = (0, 2, 0, 2)    # +2 bottom-right
_PAD21 = (0, 0, 0, 1)   # +1 bottom
_PAD31 = (0, 1, 0, 0)   # +1 right
_PAD_B2 = (0, 0, 0, 2)  # +2 bottom
_PAD_R2 = (0, 2, 0, 0)  # +2 right
_PAD_B1 = (0, 0, 0, 1)  # +1 bottom
_PAD_R1 = (0, 1, 0, 0)  # +1 right


def _fixup_v2small(xw: int, out1w: int) -> dict:
    """The reference ``TT_general_imagenet_v2_small`` if-chain (also the
    xsmall one) as a table: ``{head index: pad tuple}``."""
    if xw == 56 and out1w == 58:
        return {1: _PAD21, 2: _PAD31, 3: _PAD3, 4: _PAD3}
    if xw == 56:
        return {3: _PAD0, 4: _PAD0}
    if xw in (29, 57, 16, 15, 8, 58, 30):
        return {3: _PAD2, 4: _PAD2}
    if xw == 9 and out1w == 6:
        return {1: _PAD21, 2: _PAD31, 3: _PAD3, 4: _PAD3}
    return {}


def _fixup_v2small_alexnet(xw: int, out1w: int) -> dict:
    """The VGG-stem variant's chain (``multihead.py:95-100``): the v2small
    one plus an ``x == 11`` row (the AvgPool4 + MaxPool5 stem gives 11^2)."""
    if xw == 11:
        return {3: _PAD2, 4: _PAD2}
    return _fixup_v2small(xw, out1w)


def _fixup_v2(xw: int, out1w: int) -> dict:
    """The reference ``TT_general_imagenet_v2`` chain (``multihead.py:49``):
    the (6,5)/(5,6) heads 1 and 2 need their own one-pixel pads at 56 and
    29."""
    if xw == 56 and out1w == 58:
        return {1: _PAD21, 2: _PAD31, 3: _PAD3, 4: _PAD3}
    if xw == 56:
        return {3: _PAD0, 4: _PAD0}
    if xw == 29:
        return {1: _PAD21, 2: _PAD31, 3: _PAD3, 4: _PAD3}
    if xw == 16:
        return {3: _PAD2, 4: _PAD2}
    if xw == 9 and out1w == 6:
        return {1: _PAD21, 2: _PAD31, 3: _PAD3, 4: _PAD3}
    if xw in (58, 30):
        return {3: _PAD2, 4: _PAD2}
    return {}


def _fixup_fhe_v3(xw: int, out1w: int) -> dict:
    """The reference ``TT_FHE_SMALL`` v3 block's chain (``multihead.py:67``)."""
    if xw == 16 and out1w == 17:
        return {3: _PAD2, 4: _PAD2}
    if xw == 17:
        return {3: _PAD2, 4: _PAD2}
    if xw == 4 and out1w == 4:
        return {1: _PAD_B2, 2: _PAD_R2}
    if xw in (9, 7):
        return {3: _PAD2, 4: _PAD2}
    return {}


def _fixup_fhe_v2(xw: int, out1w: int) -> dict:
    """The reference ``TT_FHE`` (``TT_FHE_small``) block's chain
    (``multihead.py:82``): (3,2)/(2,3) heads."""
    if xw == 16:
        return {1: _PAD_B1, 2: _PAD_R1, 3: _PAD2, 4: _PAD2}
    if xw in (8, 4) and out1w == xw:
        return {1: _PAD_B1, 2: _PAD_R1}
    if xw in (17, 9, 7):
        return {3: _PAD2, 4: _PAD2}
    return {}


def _fixup_fhe_valexnet(xw: int, out1w: int) -> dict:
    """The ``TT_FHE_XSMALL_vAlexnet`` file's own v3 block
    (``multihead.py:103``): (3,2)/(2,3) heads, a chain of its own."""
    if xw == 16 and out1w == 17:
        return {3: _PAD2, 4: _PAD2}
    if xw == 4 and out1w == 4:
        return {1: _PAD_B2, 2: _PAD_R2}
    if xw == 10:
        return {1: _PAD21, 2: _PAD31, 3: _PAD2, 4: _PAD2}
    if xw in (17, 9, 8, 6):
        return {3: _PAD2, 4: _PAD2}
    return {}


# the other families' tables come with those families
FIXUP_RULES = {"v2small": _fixup_v2small,
               "v2small_alexnet": _fixup_v2small_alexnet,
               "v2": _fixup_v2,
               "fhe_v3": _fixup_fhe_v3,
               "fhe_v2": _fixup_fhe_v2,
               "fhe_valexnet": _fixup_fhe_valexnet}


@dataclasses.dataclass(frozen=True)
class MultiHeadConfig:
    in_planes: int
    out_planes: int
    stride: int = 1
    last: bool = False
    T: float = 0.0             # the heads' (and re-pools') dead zone
    # per-head group divisors (g -> Block_TT groupsici = in_planes / g)
    groups: tuple = (1, 1, 16, 1)
    k12: tuple = (4, 4)        # heads 1 and 2: kernels
    pad12: tuple = (2, 2)      # and paddings
    groupvf: int = 16
    out_mult: int = 2          # fused head outputs out_mult * out_planes
    t: int = 8
    fixup: str = "v2small"
    T_convf: float = 0.0       # the fuse head's dead zone
    # False: the block returns the raw 4-head concat, with no interleave and
    # no fuse head (the VGG-stem variant's block, ``multihead.py:150``)
    fuse: bool = True
    # True (the v2 variant only, whose reference crashes as shipped at
    # p = 64): where ``int(cin / g)`` groups do not divide the channel
    # counts, step down to the nearest divisor (``multihead.py:151-178``);
    # otherwise such a width raises
    repair_groups: bool = False

    def _groupsici(self, g: int, cin: int, cout: int) -> int:
        """``int(cin / g)`` like the reference, which crashes constructing
        a width whose group counts do not divide the channel counts;
        ``repair_groups`` steps down instead."""
        gi = max(cin // g, 1)
        if not (cin % gi or cout % gi or (self.t * cin) % gi):
            return gi
        if not self.repair_groups:
            raise ValueError(
                f"invalid group math: int({cin}/{g})={gi} groups does not "
                f"divide cin={cin}/cout={cout}/t*cin={self.t * cin} — the "
                "reference crashes constructing this width; pass a width "
                "whose group counts divide the channel counts (or set "
                "repair_groups=True to reproduce a documented "
                "crashes-as-shipped config with stepped-down groups)")
        while gi > 1 and (cin % gi or cout % gi or (self.t * cin) % gi):
            gi -= 1
        return gi

    def __post_init__(self):
        # ``multihead.py:180-192``: every head always exists
        if any(g is None for g in self.groups):
            raise ValueError(
                "MultiHeadConfig does not support disabled heads "
                f"(groups={self.groups}); the reference v2 families "
                "hardcode all four heads")

    def head_cfgs(self) -> dict:
        """BlockTTConfig per conv head (1-indexed)."""
        g1, g2, g3, _ = self.groups
        cin = self.in_planes
        return {
            1: BlockTTConfig(cin, cin, k=self.k12[0], t=self.t,
                             padding=self.pad12[0], stride=self.stride,
                             groupsici=self._groupsici(g1, cin, cin),
                             T=self.T),
            2: BlockTTConfig(cin, cin, k=self.k12[1], t=self.t,
                             padding=self.pad12[1], stride=self.stride,
                             groupsici=self._groupsici(g2, cin, cin),
                             T=self.T),
            3: BlockTTConfig(cin, cin, k=1, t=self.t, padding=0, stride=1,
                             groupsici=self._groupsici(g3, cin, cin),
                             T=self.T),
        }

    @property
    def cpt(self) -> int:
        return len(self.groups)

    def convf_cfg(self) -> BlockTTConfig:
        cin = self.cpt * self.in_planes
        cout = cin if self.last else self.out_mult * self.out_planes
        return BlockTTConfig(cin, cout, k=1, t=self.t, padding=0, stride=1,
                             groupsici=self._groupsici(self.groupvf, cin,
                                                       cout),
                             T=self.T_convf, last=self.last)

    @property
    def out_channels(self) -> int:
        if not self.fuse:
            return self.cpt * self.in_planes
        return self.convf_cfg().out_planes


class MultiHeadBlock(nn.Module):
    """Heads under the reference names ``Block_conv{1,2,3}`` and
    ``Block_convf`` (``None`` without ``cfg.fuse``), plus the block-level
    re-binarize ``act`` where the reference has one (the ttnet_imagenet
    blocks; the TT_FHE blocks have none, ``torch_export.py:88-150``)."""

    def __init__(self, cfg: MultiHeadConfig, act: bool = True):
        super().__init__()
        self.cfg = cfg
        for i, hcfg in cfg.head_cfgs().items():
            self.add_module(f"Block_conv{i}", BlockTT(hcfg))
        self.Block_convf = BlockTT(cfg.convf_cfg()) if cfg.fuse else None
        self.act = Binarize01Act() if act else None

    def head(self, i: int) -> BlockTT:
        return getattr(self, f"Block_conv{i}")

    def forward(self, x: torch.Tensor, stats: dict | None = None,
                noise: NoiseKey | None = None) -> torch.Tensor:
        return multihead_block(self, x, stats, noise)


def channel_interleave(x: torch.Tensor, cpt: int) -> torch.Tensor:
    """The reference concat-shuffle ``view(n, cpt, c/cpt, h, w)
    .transpose(1, 2)``."""
    n, c, h, w = x.shape
    return x.reshape(n, cpt, c // cpt, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def reconcile_heads(outs: dict, cfg: MultiHeadConfig, x: torch.Tensor,
                    rebinarize) -> torch.Tensor:
    """Shared by the conv block and LUT serving: head 4 is identity at
    stride 1, avg-pool + re-binarize at stride 2 (which also re-pools
    head 3), then the fixup pads, a bottom-right crop to the smallest head,
    and the channel concat.  ``rebinarize(pooled, slot)`` (slot 4 the raw
    input, 5 head 3) must equal ``binarize01_act(pooled - 0.5)``."""
    if cfg.stride == 2:
        outs[4] = rebinarize(avg_pool(x, 2), 4)
        outs[3] = rebinarize(avg_pool(outs[3], 2), 5)
    else:
        outs[4] = x
    for idx, pad in FIXUP_RULES[cfg.fixup](x.shape[3],
                                           outs[1].shape[3]).items():
        outs[idx] = zero_pad2d(outs[idx], pad)
    th = min(o.shape[2] for o in outs.values())
    tw = min(o.shape[3] for o in outs.values())
    return torch.cat([outs[i][:, :, :th, :tw] for i in sorted(outs)], dim=1)


def multihead_block(block: MultiHeadBlock, x: torch.Tensor,
                    stats: dict | None = None,
                    noise: NoiseKey | None = None) -> torch.Tensor:
    """Eval, or training when ``stats`` is given (``block_tt``); ``noise``
    keys the dead zones of a block with ``T != 0``."""
    cfg = block.cfg
    keys = {} if noise is None else {i: noise.child(i) for i in range(1, 7)}
    outs = {i: block_tt(block.head(i), x, stats=stats, noise=keys.get(i))
            for i in (1, 2, 3)}
    cat = reconcile_heads(outs, cfg, x, lambda pooled, slot: binarize01_act(
        pooled - 0.5, cfg.T, keys.get(slot)))
    if not cfg.fuse:
        return cat
    cat = channel_interleave(cat, cfg.cpt)
    return block_tt(block.Block_convf, cat, stats=stats, noise=keys.get(6))


def multihead_out_size(cfg: MultiHeadConfig, h: int, w: int):
    """Static output spatial size including the fixup pads."""
    heads = cfg.head_cfgs()
    sizes = {i: block_tt_out_size(heads[i], h, w) for i in heads}
    if cfg.stride == 2:
        sizes[4] = (h // 2, w // 2)
        sizes[3] = (sizes[3][0] // 2, sizes[3][1] // 2)
    else:
        sizes[4] = (h, w)
    for idx, (l, r, t, b) in FIXUP_RULES[cfg.fixup](w, sizes[1][1]).items():
        sh, sw = sizes[idx]
        sizes[idx] = (sh + t + b, sw + l + r)
    return (min(s[0] for s in sizes.values()),
            min(s[1] for s in sizes.values()))
