"""Plain PyTorch reference of the TTnet ImageNet family, written from the
published model (``models/TT_general_imagenet_v2_small.py`` of
github.com/Anonymousijcai2024ttnet/scale_imagenet, the shipped
``TT_vf_19lv3_imgnet_small``) in float32, with no kernel, fusion or
folding of the program under test.  It imports nothing of the program.

Network: AvgPool2d(2) -> Conv(3 -> p, k7, s2, p3) -> BN -> Heaviside ->
multi-head blocks -> AvgPool2d(2) -> Flatten -> Linear -> BN1d ->
0.47 + 0.5 x + 0.09 x^2 -> Linear.  A multi-head block runs three
Block_TT heads (two k x k depthwise, one k=1 grouped) and the raw input
(average-pooled and re-binarized at stride 2, which re-pools head 3 too),
pads them by the published if-chain, crops them to the smallest, concats,
interleaves the channels and fuses them by a k=1 Block_TT.  A Block_TT is
pad -> grouped conv (in -> t*in) -> BN -> GELU (erf) -> grouped 1x1 conv
-> BN -> Heaviside (ReLU in the last block's fuse head).

The parameter names are the published module tree's, so one state dict
loads into both this module and the program.  ``model.train()`` gives the
training forward (batch statistics, running statistics updated in place
with momentum 0.1), with the Heaviside's straight-through gradient
``g * (1 - tanh(x)^2)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _Heaviside(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        t = torch.tanh(x)
        return g * (1.0 - t * t)


class Binarize01Act(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("grad_scale", torch.tensor(1.0))

    def forward(self, x):
        return _Heaviside.apply(x)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class BlockTT(nn.Module):
    def __init__(self, cin, cout, k, stride, padding, groups, t=8,
                 last=False):
        super().__init__()
        self.padding, self.stride, self.groups = padding, stride, groups
        self.last = last
        self.conv1 = nn.Conv2d(cin, t * cin, _pair(k), stride=stride,
                               groups=groups, bias=False)
        self.bn1 = nn.BatchNorm2d(t * cin)
        self.conv2 = nn.Conv2d(t * cin, cout, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.act = Binarize01Act()

    def forward(self, x):
        if self.padding:
            x = F.pad(x, (self.padding,) * 4)
        y = self.bn2(self.conv2(F.gelu(self.bn1(self.conv1(x)))))
        return torch.relu(y) if self.last else self.act(y)


# the published pad if-chain of the "small" block: {head: ZeroPad2d tuple
# (left, right, top, bottom)}, keyed by the input width and head 1's width
def _fixup_small(xw, out1w):
    if xw == 56 and out1w == 58:
        return {1: (0, 0, 0, 1), 2: (0, 1, 0, 0), 3: (0, 2, 0, 2),
                4: (0, 2, 0, 2)}
    if xw == 56:
        return {3: (1, 0, 1, 0), 4: (1, 0, 1, 0)}
    if xw in (29, 57, 16, 15, 8, 58, 30):
        return {3: (0, 1, 0, 1), 4: (0, 1, 0, 1)}
    if xw == 9 and out1w == 6:
        return {1: (0, 0, 0, 1), 2: (0, 1, 0, 0), 3: (0, 2, 0, 2),
                4: (0, 2, 0, 2)}
    return {}


FIXUPS = {"v2small": _fixup_small}


class MultiHead(nn.Module):
    def __init__(self, cin, cout, stride, last, m):
        super().__init__()
        g1, g2, g3, _ = m["groups"]
        t = m["t"]
        self.stride, self.fixup = stride, FIXUPS[m["fixup"]]
        for i, (k, pad, g) in enumerate(
                ((m["k12"][0], m["pad12"][0], g1),
                 (m["k12"][1], m["pad12"][1], g2), (1, 0, g3)), 1):
            self.add_module(f"Block_conv{i}", BlockTT(
                cin, cin, k, stride if i < 3 else 1, pad,
                max(cin // g, 1), t))
        cf = 4 * cin
        self.Block_convf = BlockTT(
            cf, cf if last else m["out_mult"] * cout, 1, 1, 0,
            max(cf // m["groupvf"], 1), t, last=last)
        self.act = Binarize01Act()

    def forward(self, x):
        outs = {i: getattr(self, f"Block_conv{i}")(x) for i in (1, 2, 3)}
        if self.stride == 2:
            outs[4] = self.act(F.avg_pool2d(x, 2) - 0.5)
            outs[3] = self.act(F.avg_pool2d(outs[3], 2) - 0.5)
        else:
            outs[4] = x
        for i, pad in self.fixup(x.shape[3], outs[1].shape[3]).items():
            outs[i] = F.pad(outs[i], pad)
        th = min(o.shape[2] for o in outs.values())
        tw = min(o.shape[3] for o in outs.values())
        cat = torch.cat([outs[i][:, :, :th, :tw] for i in (1, 2, 3, 4)], 1)
        n, c, h, w = cat.shape
        cat = cat.reshape(n, 4, c // 4, h, w).transpose(1, 2).reshape(
            n, c, h, w)
        return self.Block_convf(cat)


class ClassifierScale(nn.Module):
    def __init__(self, fcsize, inter, classes):
        super().__init__()
        self.lin1 = nn.Linear(fcsize, inter, bias=False)
        self.BN2 = nn.BatchNorm1d(inter)
        self.lin2 = nn.Linear(inter, classes)

    def forward(self, x):
        y = self.BN2(self.lin1(x))
        return self.lin2(0.47 + 0.50 * y + 0.09 * y * y)


STAGES = {0: [(1, 2), (2, 2)], 1: [(1, 2), (2, 2), (4, 2)],
          2: [(1, 2), (2, 2), (4, 2), (8, 2)],
          3: [(1, 1), (2, 2), (4, 2), (8, 2)],
          4: [(1, 1), (2, 2), (2, 1), (4, 2), (8, 2)]}


def _stages(cfg: dict) -> list:
    p = cfg["nfilter"] * cfg["tfilter"]
    stages = [(p * m, s) for m, s in STAGES[cfg["layers"]]]
    blocks, cin = [], p
    for out, stride in stages:
        blocks.append(MultiHead(cin, out, stride, out == stages[-1][0],
                                cfg["block"]))
        cin = 2 * out
    return blocks


def _fcsize(cfg: dict) -> int:
    """The classifier's input size: the blocks run once on the meta
    device, from the stem's output size (a quarter of the image's)."""
    p = cfg["nfilter"] * cfg["tfilter"]
    with torch.device("meta"):
        s = cfg["image_size"] // 4
        c, h, w = nn.Sequential(*_stages(cfg))(
            torch.zeros(1, p, s, s)).shape[1:]
    return c * (h // 2) * (w // 2)


class TTnetImageNet(nn.Module):
    """``cfg``: the configuration file's ``model`` object."""

    def __init__(self, cfg: dict):
        super().__init__()
        p = cfg["nfilter"] * cfg["tfilter"]
        self.features = nn.Sequential(
            nn.AvgPool2d(2), nn.Conv2d(3, p, 7, 2, 3, bias=False),
            nn.BatchNorm2d(p), Binarize01Act(), *_stages(cfg),
            nn.AvgPool2d(2), nn.Flatten(),
            ClassifierScale(_fcsize(cfg), cfg["classifier_inter"],
                            cfg["num_classes"]))

    def forward(self, x_nchw):
        return self.features(x_nchw)


def build(cfg: dict) -> nn.Module:
    """The network of the configuration file's ``model`` object, on the
    meta device: the caller moves it (``to_empty``) and loads weights."""
    with torch.device("meta"):
        return TTnetImageNet(cfg)
