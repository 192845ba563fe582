"""Plain PyTorch reference of the v1 TTnet ImageNet family, written from
the published model (``models/TT_general_imagenet.py`` of
github.com/Anonymousijcai2024ttnet/scale_imagenet; ``TT_vf_19lv2_imgnet``,
its best v1 model) in float32, eval only.  It imports nothing of the
program under test.

Network: AvgPool2d(2) -> Conv(3 -> p, k7, s2, p3) -> BN -> Heaviside ->
multi-head blocks -> AvgPool2d(2) -> Flatten -> Linear.  A block runs
three ``Block_resnet_BN`` heads (k 7, 4, 2 with pads 3, 2, 1 and
``in / g`` groups for g = 1, 2, 4) and a fourth head (ZeroPad2d(1) +
AvgPool2d(2) at stride 2, the identity at stride 1); at input widths 56,
30 and 16 heads 2 and 3 lose their last row and column; all heads are
cropped to the smallest, concatenated, channel-interleaved and fused by a
k=2 pad-1 cell.  A cell is conv (in -> 8 in, its pad) -> BN -> GELU ->
grouped 1x1 conv -> BN -> the 2-bit activation quantizer
``3 * round(3 clip(x, 0, 1)) / 3`` (a GELU in the fuse head).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Binarize01Act(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("grad_scale", torch.tensor(1.0))

    def forward(self, x):
        return (x >= 0).to(x.dtype)


class Cell(nn.Module):
    def __init__(self, cin, cout, k, pad, stride, groups, last, a_bit):
        super().__init__()
        self.last, self.levels = last, 2 ** a_bit - 1
        self.conv1 = nn.Conv2d(cin, 8 * cin, k, stride=stride, padding=pad,
                               groups=groups, bias=False)
        self.bn1 = nn.BatchNorm2d(8 * cin)
        self.conv2 = nn.Conv2d(8 * cin, cout, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)

    def forward(self, x):
        y = self.bn2(self.conv2(F.gelu(self.bn1(self.conv1(x)))))
        if self.last:
            return F.gelu(y)
        n = float(self.levels)
        return n * (torch.round(y.clamp(0.0, 1.0) * n) / n)


HEADS = ((7, 3, 1), (4, 2, 2), (2, 1, 4))     # (kernel, pad, divisor)


class MultiHead(nn.Module):
    def __init__(self, cin, cout, stride, a_bit):
        super().__init__()
        self.stride = stride
        for i, (k, pad, g) in enumerate(HEADS, 1):
            self.add_module(f"Block_conv{i}", Cell(
                cin, cin, k, pad, stride, cin // g, False, a_bit))
        cf = 4 * cin
        groups = max(cf // 8, 1)
        while groups > 1 and (cf % groups or cout % groups):
            groups -= 1
        self.Block_convf = Cell(cf, cout, 2, 1, 1, groups, True, a_bit)

    def forward(self, x):
        outs = {i: getattr(self, f"Block_conv{i}")(x) for i in (1, 2, 3)}
        outs[4] = F.avg_pool2d(F.pad(x, (1, 1, 1, 1)), 2) \
            if self.stride == 2 else x
        if x.shape[3] in (56, 30, 16):
            for i in (2, 3):
                outs[i] = outs[i][:, :, :-1, :-1]
        th = min(o.shape[2] for o in outs.values())
        tw = min(o.shape[3] for o in outs.values())
        cat = torch.cat([outs[i][:, :, :th, :tw] for i in (1, 2, 3, 4)], 1)
        n, c, h, w = cat.shape
        cat = cat.reshape(n, 4, c // 4, h, w).transpose(1, 2).reshape(
            n, c, h, w)
        return self.Block_convf(cat)


# TT_vf_19lv2_imgnet's stages: (out as a multiple of p, stride)
STAGES = {"TT_vf_19lv2_imgnet": [(1, 1), (2, 2), (2, 1), (4, 2), (8, 2)]}


def _stages(cfg: dict) -> list:
    p = cfg["nfilter"] * cfg["tfilter"]
    blocks, cin = [], p
    for m, stride in STAGES[cfg["stages"]]:
        blocks.append(MultiHead(cin, p * m, stride, cfg["a_bit"]))
        cin = p * m
    return blocks


def _fcsize(cfg: dict) -> int:
    p = cfg["nfilter"] * cfg["tfilter"]
    with torch.device("meta"):
        s = cfg["image_size"] // 4
        c, h, w = nn.Sequential(*_stages(cfg))(
            torch.zeros(1, p, s, s)).shape[1:]
    return c * (h // 2) * (w // 2)


class TTnetV1(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        p = cfg["nfilter"] * cfg["tfilter"]
        self.features = nn.Sequential(
            nn.AvgPool2d(2), nn.Conv2d(3, p, 7, 2, 3, bias=False),
            nn.BatchNorm2d(p), Binarize01Act(), *_stages(cfg),
            nn.AvgPool2d(2), nn.Flatten(),
            nn.Linear(_fcsize(cfg), cfg["num_classes"]))

    def forward(self, x_nchw):
        return self.features(x_nchw)


def build(cfg: dict) -> nn.Module:
    """The network of the configuration file's ``model`` object, on the
    meta device: the caller moves it (``to_empty``) and loads weights."""
    with torch.device("meta"):
        return TTnetV1(cfg)
