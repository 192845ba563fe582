"""The float (pre-TT) general family (counterpart of
``scale_imagenet_tpu/models/ttnet_general_float.py``): ``TT_general``,
``TT_general_big``, ``TT_general_8`` and the "correct BN" twins
``TT_general_correctBN`` (224x224) and ``TT_general_correctBN_cifar``.

The float cell is conv -> BN -> GELU [-> 1x1 ``conv1b`` -> BN -> GELU in
``_big``] -> 1x1 conv -> the 2-bit quantizer -> BN: the activation
*before* bn2, and GELU(bn2(.)) in the ``last`` fuse head
(``ttnet_general_float.py:47-75``).  The heads are k = 4/3/2/1 cells
(8/4/2/1 in ``TT_general_8``, which runs three heads at most), their
outputs cropped bottom-right to the smallest and channel-interleaved into
a k = 2 fuse head.  The stem puts the quantizer before its BN
(AvgPool(2) -> conv 7x7 s2 p3; ``TT_general_8``: conv 7x7 s1 p3).

correctBN runs the v1 family's cell order (``block_resnet_bn``: the
activation after bn2), with the BN before the stem's quantizer; its
blocks concatenate the identity-or-AvgPool input, a k = 4 pad 2 head and
a k = 2 pad 1 head, cropped by the reference's table and then to the
smallest, and interleave them by a ``cpt`` that also counts the
never-concatenated fourth group, as the reference does
(``ttnet_general_float.py:250-258,340-351``).  Modules under the JAX
trees' names (``models/ttnet_cifar.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..layers.conv import conv2d
from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..layers.pool import avg_pool, flatten
from ..ops.binarize import binarize01_act
from ..ops.gelu import gelu
from ..ops.quantize import activation_quantize
from .multihead import channel_interleave
from .ttnet_cifar import BlockResnet, BlockResnetConfig, \
    block_resnet_out_size, blocks_of, nchw, stage_pairs
from .ttnet_imagenet_v1 import block_resnet_bn


class BlockResnetBig(BlockResnet):
    """Block_resnet_big (``ttnet_general_float.py:32``): an extra 1x1
    ``conv1b``/``bn1b`` between the two convs."""

    def __init__(self, cfg: BlockResnetConfig):
        super().__init__(cfg)
        mid = cfg.a * cfg.in_planes
        self.conv1b = nn.Conv2d(mid, mid, 1, groups=cfg.groupsici,
                                bias=False)
        self.bn1b = nn.BatchNorm2d(mid)


def _act(x: torch.Tensor, a_bit: int) -> torch.Tensor:
    """The 2-bit quantizer, or the Heaviside at ``a_bit = 1``."""
    return activation_quantize(x, a_bit) if a_bit > 1 else binarize01_act(x)


def block_resnet_float(block: BlockResnet, x: torch.Tensor,
                       stats: dict | None = None,
                       pre_padded: bool = False) -> torch.Tensor:
    """``ttnet_general_float.py:47``: conv1 -> bn1 -> GELU [-> conv1b ->
    bn1b -> GELU] -> conv2 -> act -> bn2, or GELU(bn2(conv2)) when
    ``last``; ``pre_padded`` as in ``first_half``."""
    cfg = block.cfg
    out = conv2d(x, block.conv1.weight, block.conv1.bias, stride=cfg.stride,
                 padding=0 if pre_padded else cfg.padding,
                 groups=cfg.groupsici)
    out = gelu(batch_norm(block.bn1, out, stats))
    if isinstance(block, BlockResnetBig):
        out = conv2d(out, block.conv1b.weight, block.conv1b.bias,
                     groups=cfg.groupsici)
        out = gelu(batch_norm(block.bn1b, out, stats))
    out = conv2d(out, block.conv2.weight, block.conv2.bias,
                 groups=cfg.groupsici)
    if cfg.last:
        return gelu(batch_norm(block.bn2, out, stats))
    return batch_norm(block.bn2, _act(out, cfg.a_bit), stats)


# variant -> head kernels and pads, the fuse head's kernel and pad (and
# fixed group divisor), the big cell, the stem, the head-count cap
FLOAT_VARIANTS = {
    "general": dict(ks=(4, 3, 2, 1), pads=(1, 1, 0, 0), convf_k=2,
                    convf_pad=1, big=False, stem="pool_s2"),
    # the reference builds Block_conv4 when groups[3] is set but never
    # concatenates it: three heads at most (``ttnet_general_float.py:89``)
    "general_8": dict(ks=(8, 4, 2, 1), pads=(3, 1, 0, 0), convf_k=3,
                      convf_pad=1, big=False, convf_gdiv=6, stem="s1",
                      max_heads=3),
    "general_big": dict(ks=(4, 3, 2, 1), pads=(1, 1, 0, 0), convf_k=2,
                        convf_pad=1, big=True, stem="pool_s2"),
}


@dataclasses.dataclass(frozen=True)
class FloatMultiHeadConfig:
    in_planes: int
    out_planes: int
    stride: int = 1
    a_bit: int = 2
    groups: tuple = (1, 2, 4, 4)   # None entries disable heads
    variant: str = "general"

    @property
    def spec(self) -> dict:
        return FLOAT_VARIANTS[self.variant]

    def _effective_groups(self) -> tuple:
        cap = self.spec.get("max_heads", len(self.groups))
        return tuple(g if i < cap else None
                     for i, g in enumerate(self.groups))

    def head_cfgs(self) -> dict:
        return {i + 1: BlockResnetConfig(
            self.in_planes, self.in_planes, k=self.spec["ks"][i],
            padding=self.spec["pads"][i], stride=self.stride,
            groupsici=self.in_planes // g, a_bit=self.a_bit)
            for i, g in enumerate(self._effective_groups()) if g is not None}

    @property
    def cpt(self) -> int:
        return sum(1 for g in self._effective_groups() if g is not None)

    def convf_cfg(self) -> BlockResnetConfig:
        """The fuse head's groups: ``cin / gdiv`` when it divides, else 1;
        ``gdiv`` the variant's, or the third group (the second's + 2 when
        the third is disabled), as the reference reaches it."""
        cin = self.cpt * self.in_planes
        gdiv = self.spec.get("convf_gdiv")
        if gdiv is None:
            gdiv = self.groups[2] if self.groups[2] is not None \
                else (self.groups[1] or 1) + 2
        g = cin // gdiv if gdiv and cin % gdiv == 0 else 1
        return BlockResnetConfig(cin, self.out_planes, k=self.spec["convf_k"],
                                 padding=self.spec["convf_pad"], stride=1,
                                 groupsici=g, last=True, a_bit=self.a_bit)


class FloatMultiHead(nn.Module):
    """Heads ``conv{i}`` and ``convf``, big cells in ``_big``."""

    def __init__(self, cfg: FloatMultiHeadConfig):
        super().__init__()
        self.cfg = cfg
        cell = BlockResnetBig if cfg.spec["big"] else BlockResnet
        for i, hcfg in cfg.head_cfgs().items():
            self.add_module(f"conv{i}", cell(hcfg))
        self.convf = cell(cfg.convf_cfg())

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return float_multihead(self, x, stats)


def _crop_cat(outs: list) -> torch.Tensor:
    """Each output cropped bottom-right to the smallest, concatenated."""
    th = min(o.shape[2] for o in outs)
    tw = min(o.shape[3] for o in outs)
    return torch.cat([o[:, :, :th, :tw] for o in outs], dim=1)


def float_multihead(block: FloatMultiHead, x: torch.Tensor,
                    stats: dict | None = None) -> torch.Tensor:
    """``ttnet_general_float.py:153``: the heads, the crop, the interleave
    and the fuse head."""
    cfg = block.cfg
    outs = [block_resnet_float(getattr(block, f"conv{i}"), x, stats)
            for i in sorted(cfg.head_cfgs())]
    cat = channel_interleave(_crop_cat(outs), cfg.cpt)
    return block_resnet_float(block.convf, cat, stats)


def float_multihead_out_size(cfg: FloatMultiHeadConfig, h: int,
                             w: int) -> tuple[int, int]:
    sizes = [block_resnet_out_size(c, h, w)
             for c in cfg.head_cfgs().values()]
    return block_resnet_out_size(cfg.convf_cfg(),
                                 min(s[0] for s in sizes),
                                 min(s[1] for s in sizes))


def _stage_list(p: int, layers: int, big: bool = False) -> list:
    """The stage tables of ``ttnet_general_float.py:229``; ``_big`` drops
    the leading stride-1 stage.  Any ``layers`` but 18 is the 30-layer
    table, as in the JAX package."""
    if big:
        stages = [(2 * p, 2), (4 * p, 2), (8 * p, 2)] if layers == 18 \
            else [(2 * p, 2), (4 * p, 2), 4 * p, (8 * p, 2), 8 * p]
    else:
        stages = [p, (2 * p, 2), (4 * p, 2), (8 * p, 2)] if layers == 18 \
            else [p, (2 * p, 2), (4 * p, 2), 4 * p, (8 * p, 2), 8 * p]
    return stage_pairs(stages)


@dataclasses.dataclass(frozen=True)
class TTGeneralFloatConfig:
    variant: str = "general"
    nfilter: int = 8
    tfilter: int = 8
    layers: int = 18          # 18 | 30
    a_bit: int = 2
    num_classes: int = 1000
    image_size: int = 224
    groups: tuple = (1, 2, 4, 4)

    @property
    def p(self) -> int:
        return self.nfilter * self.tfilter

    def block_configs(self) -> list[FloatMultiHeadConfig]:
        in_planes, cfgs = self.p, []
        for out_planes, stride in _stage_list(
                self.p, self.layers, self.variant == "general_big"):
            cfgs.append(FloatMultiHeadConfig(
                in_planes, out_planes, stride=stride, a_bit=self.a_bit,
                groups=self.groups, variant=self.variant))
            in_planes = out_planes
        return cfgs

    @property
    def fcsize(self) -> int:
        if FLOAT_VARIANTS[self.variant]["stem"] == "s1":
            h = self.image_size
        else:
            h = (self.image_size // 2 + 6 - 7) // 2 + 1
        w, c = h, self.p
        for cfg in self.block_configs():
            h, w = float_multihead_out_size(cfg, h, w)
            c = cfg.out_planes
        return (h // 2) * (w // 2) * c


class TTGeneralFloat(nn.Module):
    def __init__(self, cfg: TTGeneralFloatConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.p, 7, bias=False)
        self.stem_bn = nn.BatchNorm2d(cfg.p)
        blocks = cfg.block_configs()
        self.n_blocks = len(blocks)
        for i, bcfg in enumerate(blocks):
            self.add_module(f"block{i}", FloatMultiHead(bcfg))
        self.fc = nn.Linear(cfg.fcsize, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return tt_general_float_apply(self, x, stats)


def tt_general_float_apply(model: TTGeneralFloat, x: torch.Tensor,
                           stats: dict | None = None) -> torch.Tensor:
    """``ttnet_general_float.py:484``: the stem (the quantizer before its
    BN), the blocks, AvgPool(2), Flatten, Linear."""
    cfg, conv = model.cfg, model.stem_conv
    h = nchw(x, model)
    if FLOAT_VARIANTS[cfg.variant]["stem"] == "s1":
        h = conv2d(h, conv.weight, conv.bias, padding=3)
    else:
        h = conv2d(avg_pool(h, 2), conv.weight, conv.bias, stride=2,
                   padding=3)
    h = batch_norm(model.stem_bn, _act(h, cfg.a_bit), stats)
    for block in blocks_of(model):
        h = block(h, stats)
    return linear(flatten(avg_pool(h, 2)), model.fc.weight, model.fc.bias)


# ---------------------------------------------------------------------------
# TT_general_correctBN (``ttnet_general_float.py:215-462``)


@dataclasses.dataclass(frozen=True)
class CorrectBNBlockConfig:
    in_planes: int
    out_planes: int
    stride: int = 1
    a_bit: int = 2
    groups: tuple = (1, 2, 4, None)

    def head_cfgs(self) -> dict:
        cfgs = {}
        for i, k, pad, g in ((2, 4, 2, self.groups[1]),
                             (3, 2, 1, self.groups[2])):
            if g is not None:
                cfgs[i] = BlockResnetConfig(
                    self.in_planes, self.in_planes, k=k, padding=pad,
                    stride=self.stride, groupsici=self.in_planes // g,
                    a_bit=self.a_bit)
        return cfgs

    @property
    def cpt(self) -> int:
        # every non-None group, the never-concatenated fourth included
        return sum(1 for g in self.groups if g is not None)

    def convf_cfg(self) -> BlockResnetConfig:
        cin = 3 * self.in_planes              # always a 3-head concat
        groupvf = 9 if self.stride == 2 else 12
        return BlockResnetConfig(cin, self.out_planes, k=2, padding=1,
                                 stride=1, groupsici=cin // groupvf,
                                 last=True, a_bit=self.a_bit)


def _correctbn_crops(stride: int, w: int) -> tuple:
    """The reference's crop table (``ttnet_general_float.py:330``): the
    outputs (1 the input, 2 and 3 the heads) cropped by a pixel."""
    if (stride == 1 and w == 16) or (stride == 2 and w in (17, 9, 5)):
        return (2, 3)
    if stride == 2 and w in (11, 7):
        return (1,)
    return ()


class CorrectBNBlock(nn.Module):
    """Heads ``conv2`` (k = 4) and ``conv3`` (k = 2) and ``convf``."""

    def __init__(self, cfg: CorrectBNBlockConfig):
        super().__init__()
        self.cfg = cfg
        for i, hcfg in cfg.head_cfgs().items():
            self.add_module(f"conv{i}", BlockResnet(hcfg))
        self.convf = BlockResnet(cfg.convf_cfg())

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return correctbn_block(self, x, stats)


def correctbn_block(block: CorrectBNBlock, x: torch.Tensor,
                    stats: dict | None = None) -> torch.Tensor:
    """``ttnet_general_float.py:317``: both heads are run (a disabled one
    fails, as in the reference), the crop table, the crop to the
    smallest, the interleave by ``cpt`` and the fuse head."""
    cfg = block.cfg
    outs = {2: block_resnet_bn(block.conv2, x, stats),
            3: block_resnet_bn(block.conv3, x, stats),
            1: avg_pool(x, 2) if cfg.stride == 2 else x}
    for i in _correctbn_crops(cfg.stride, x.shape[3]):
        outs[i] = outs[i][:, :, :-1, :-1]
    cat = channel_interleave(_crop_cat([outs[1], outs[2], outs[3]]),
                             cfg.cpt)
    return block_resnet_bn(block.convf, cat, stats)


def correctbn_block_out_size(cfg: CorrectBNBlockConfig, h: int,
                             w: int) -> tuple[int, int]:
    heads = cfg.head_cfgs()
    sizes = {i: block_resnet_out_size(c, h, w) for i, c in heads.items()}
    sizes[1] = (h // 2, w // 2) if cfg.stride == 2 else (h, w)
    for i in _correctbn_crops(cfg.stride, w):
        sizes[i] = (sizes[i][0] - 1, sizes[i][1] - 1)
    return block_resnet_out_size(cfg.convf_cfg(),
                                 min(s[0] for s in sizes.values()),
                                 min(s[1] for s in sizes.values()))


@dataclasses.dataclass(frozen=True)
class TTGeneralCorrectBNConfig:
    nfilter: int = 8
    tfilter: int = 6          # p = 48: % 12 == 0 as groupvf demands
    layers: int = 18          # 18 | 30
    a_bit: int = 2
    num_classes: int = 10     # 512 -> 10 even in the ImageNet file
    image_size: int = 32      # 32 (the CIFAR twin) | 224
    groups: tuple = (1, 2, 4, None)
    inter: int = 512

    @property
    def p(self) -> int:
        return self.nfilter * self.tfilter

    def block_configs(self) -> list[CorrectBNBlockConfig]:
        in_planes, cfgs = self.p, []
        for out_planes, stride in _stage_list(self.p, self.layers):
            cfgs.append(CorrectBNBlockConfig(
                in_planes, out_planes, stride=stride, a_bit=self.a_bit,
                groups=self.groups))
            in_planes = out_planes
        return cfgs

    @property
    def fcsize(self) -> int:
        s = self.image_size if self.image_size == 32 \
            else self.image_size // 2
        h = w = (s + 6 - 7) // 2 + 1
        c = self.p
        for cfg in self.block_configs():
            h, w = correctbn_block_out_size(cfg, h, w)
            c = cfg.out_planes
        return (h // 2) * (w // 2) * c


class TTGeneralCorrectBN(nn.Module):
    def __init__(self, cfg: TTGeneralCorrectBNConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.p, 7, bias=False)
        self.stem_bn = nn.BatchNorm2d(cfg.p)
        blocks = cfg.block_configs()
        self.n_blocks = len(blocks)
        for i, bcfg in enumerate(blocks):
            self.add_module(f"block{i}", CorrectBNBlock(bcfg))
        self.fc1 = nn.Linear(cfg.fcsize, cfg.inter)
        self.fc2 = nn.Linear(cfg.inter, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return tt_general_correctbn_apply(self, x, stats)


def tt_general_correctbn_apply(model: TTGeneralCorrectBN, x: torch.Tensor,
                               stats: dict | None = None) -> torch.Tensor:
    """``ttnet_general_float.py:443``: [AvgPool(2) at 224] -> conv 7x7 s2
    p3 -> BN -> the quantizer, the blocks, AvgPool(2), Flatten, two
    Linears."""
    cfg, conv = model.cfg, model.stem_conv
    h = nchw(x, model)
    if cfg.image_size != 32:
        h = avg_pool(h, 2)
    h = conv2d(h, conv.weight, conv.bias, stride=2, padding=3)
    h = _act(batch_norm(model.stem_bn, h, stats), cfg.a_bit)
    for block in blocks_of(model):
        h = block(h, stats)
    h = linear(flatten(avg_pool(h, 2)), model.fc1.weight, model.fc1.bias)
    return linear(h, model.fc2.weight, model.fc2.bias)
