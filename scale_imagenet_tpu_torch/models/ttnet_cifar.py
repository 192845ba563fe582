"""The resnet cell of the CIFAR TTnet family (counterpart of
``scale_imagenet_tpu/models/ttnet_cifar.py:40-87``), which the v1 ImageNet
family (``models/ttnet_imagenet_v1.py``) builds on.

``Block_resnet`` (the reference's ``TT.py:160-185``)::

    conv(k, in -> a*in, ``groupsici`` groups) -> BN -> GELU
    -> 1x1 grouped conv (a*in -> out) -> [2-bit quantizer] -> BN -> GELU

The quantizer sits between the second conv and its BN, and is left out in
the ``last`` block; a GELU closes the cell either way.  Parameters under
the reference names ``conv1``/``bn1``/``conv2``/``bn2``.  NCHW, eval, or
training when given ``stats`` (``layers/norm.py``).  The rest of the file
(``model_general``, the mobilenet variants) comes with its family
(``ROADMAP.md`` queue A 4).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..layers.conv import conv2d
from ..layers.norm import batch_norm
from ..ops.gelu import gelu
from ..ops.quantize import activation_quantize


def _as_pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


@dataclasses.dataclass(frozen=True)
class BlockResnetConfig:
    in_planes: int
    out_planes: int
    k: int = 3
    a: int = 8           # amplification of the first conv
    padding: int = 1
    stride: int = 1
    groupsici: int = 1
    last: bool = False
    a_bit: int = 2       # activation_quantize_fn2's default


class BlockResnet(nn.Module):
    """The cell's parameters; ``forward`` is ``block_resnet``.  The v1
    family runs the same parameters through its own order
    (``ttnet_imagenet_v1.block_resnet_bn``)."""

    def __init__(self, cfg: BlockResnetConfig):
        super().__init__()
        self.cfg = cfg
        mid = cfg.a * cfg.in_planes
        self.conv1 = nn.Conv2d(cfg.in_planes, mid, _as_pair(cfg.k),
                               stride=cfg.stride, padding=cfg.padding,
                               groups=cfg.groupsici, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, cfg.out_planes, 1, groups=cfg.groupsici,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(cfg.out_planes)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return block_resnet(self, x, stats)


def first_half(block: BlockResnet, x: torch.Tensor,
               stats: dict | None = None) -> torch.Tensor:
    """conv1 -> BN -> GELU -> conv2, shared by both cell orders."""
    cfg = block.cfg
    out = conv2d(x, block.conv1.weight, block.conv1.bias, stride=cfg.stride,
                 padding=cfg.padding, groups=cfg.groupsici)
    out = gelu(batch_norm(block.bn1, out, stats))
    return conv2d(out, block.conv2.weight, block.conv2.bias,
                  groups=cfg.groupsici)


def block_resnet(block: BlockResnet, x: torch.Tensor,
                 stats: dict | None = None) -> torch.Tensor:
    """``ttnet_cifar.py:68``: the quantizer before bn2, a GELU after."""
    out = first_half(block, x, stats)
    if not block.cfg.last:
        out = activation_quantize(out, block.cfg.a_bit)
    return gelu(batch_norm(block.bn2, out, stats))


def block_resnet_out_size(cfg: BlockResnetConfig, h: int,
                          w: int) -> tuple[int, int]:
    kh, kw = _as_pair(cfg.k)
    return ((h + 2 * cfg.padding - kh) // cfg.stride + 1,
            (w + 2 * cfg.padding - kw) // cfg.stride + 1)
