"""The TTnet ImageNet family (counterpart of ``scale_imagenet_tpu/models/ttnet_imagenet.py:36-195``).

Skeleton: AvgPool2d(2) -> Conv(3->p, k7, s2, p3) -> BN -> Heaviside -> a
stage list of multi-head blocks -> AvgPool2d(2) -> Flatten ->
Classifier_scale.  The module tree is the reference ``features``
Sequential, so an exported reference ``.pth`` loads with ``strict=True``.
The s2d stem (default) evaluates the first two layers as one conv.

Public functions take NHWC images ``(B, H, W, 3)`` and return ``(B,
classes)`` logits.  Each runs in eval mode, or in training mode when given
a ``stats`` dict, which then receives every BN's new running statistics
(``layers/norm.py``; ``train/steps.py`` writes them).  With
``cfg.remat`` the training forward runs each multi-head block under
``torch.utils.checkpoint``, as ``jax.checkpoint`` does at
``scale_imagenet_tpu/models/ttnet_imagenet.py:167-182``.

The VGG-stem variant (``TTnetVGGStem``, ``ttnet_imagenet.py:199-277``)
follows the family: AvgPool(4) -> two 3x3 convs with bias and ReLU -> BN
-> MaxPool(5) -> Heaviside -> one xsmall multi-head block that returns its
raw 4-head concat -> Flatten -> Classifier_scale.  It takes ``stats`` too;
the JAX package keeps no ``remat`` for it (its CLI refuses ``--remat``
there).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import exact_float32, resolve_device
from ..kernels.stem import space_to_depth_stem
from ..layers.conv import conv2d
from ..layers.norm import batch_norm
from ..layers.pool import avg_pool, flatten, max_pool
from ..ops.binarize import Binarize01Act, binarize01_act
from .classifier import ClassifierScale, classifier_scale
from .multihead import MultiHeadBlock, MultiHeadConfig, multihead_out_size

BLOCK_VARIANTS = {
    "small": dict(k12=(4, 4), pad12=(2, 2), groups=(1, 1, 16, 1),
                  groupvf=16, fixup="v2small"),
    "xsmall": dict(k12=(2, 2), pad12=(1, 1), groups=(1, 1, 4, 1),
                   groupvf=4, fixup="v2small"),
    # flagship geometry with head 3 / convf grouped at 8 channels: n=8
    # truth tables there instead of n=16
    "small_g8": dict(k12=(4, 4), pad12=(2, 2), groups=(1, 1, 8, 1),
                     groupvf=8, fixup="v2small"),
    # ``TT_vf_19lv3_imgnet`` (``ttnet_imagenet.py:57-58``): (6,5)/(5,6)
    # depthwise heads 1 and 2 (n = 30 bits: no truth table), head 3 and the
    # fuse head grouped at 30; the reference crashes as shipped at p = 64
    # (int(512/30) = 17 groups on 512 channels), so its group counts step
    # down to the nearest divisor (``repair_groups``)
    "v2": dict(k12=((6, 5), (5, 6)), pad12=(3, 3), groups=(1, 1, 30, 1),
               groupvf=30, fixup="v2", repair_groups=True),
}


def _stage_cfg(p: int, layers: int):
    """The ``--layers`` stage tables; entries are ``(out_planes, stride)``."""
    tables = {
        0: [(p, 2), (2 * p, 2)],
        1: [(p, 2), (2 * p, 2), (4 * p, 2)],
        2: [(p, 2), (2 * p, 2), (4 * p, 2), (8 * p, 2)],
        3: [(p, 1), (2 * p, 2), (4 * p, 2), (8 * p, 2)],
        4: [(p, 1), (2 * p, 2), (2 * p, 1), (4 * p, 2), (8 * p, 2)],
    }
    return tables[layers]


@dataclasses.dataclass(frozen=True)
class TTnetImageNetConfig:
    variant: str = "small"
    nfilter: int = 8
    tfilter: int = 8
    layers: int = 1
    num_classes: int = 1000
    image_size: int = 224
    classifier_inter: int = 1000
    # "s2d": avgpool+conv7 folded into one space-to-depth conv (exact up to
    # float summation order); "reference": the literal op order
    stem_impl: str = "s2d"
    # recompute each multi-head block's activations in the training
    # backward instead of keeping them (device memory for operations; the
    # values are the same)
    remat: bool = False

    @property
    def p(self) -> int:
        return self.nfilter * self.tfilter

    def block_configs(self) -> list[MultiHeadConfig]:
        stages = _stage_cfg(self.p, self.layers)
        last_out = stages[-1][0]
        in_planes = self.p
        cfgs = []
        for out_planes, stride in stages:
            cfgs.append(MultiHeadConfig(
                in_planes=in_planes, out_planes=out_planes, stride=stride,
                last=out_planes == last_out, **BLOCK_VARIANTS[self.variant]))
            in_planes = 2 * out_planes
        return cfgs

    def feature_shape(self) -> tuple[int, int, int]:
        """(H, W, C) entering the flatten."""
        s = self.image_size // 2          # stem AvgPool2d(2)
        s = (s + 2 * 3 - 7) // 2 + 1      # stem conv k7 s2 p3
        h = w = s
        c = self.p
        for cfg in self.block_configs():
            h, w = multihead_out_size(cfg, h, w)
            c = cfg.out_channels
        return h // 2, w // 2, c          # trailing AvgPool2d(2)

    @property
    def fcsize(self) -> int:
        h, w, c = self.feature_shape()
        return h * w * c


class TTnetImageNet(nn.Module):
    def __init__(self, cfg: TTnetImageNetConfig):
        super().__init__()
        self.cfg = cfg
        blocks = [MultiHeadBlock(b) for b in cfg.block_configs()]
        self.n_blocks = len(blocks)
        self.features = nn.Sequential(
            nn.AvgPool2d(2),
            nn.Conv2d(3, cfg.p, 7, stride=2, padding=3, bias=False),
            nn.BatchNorm2d(cfg.p),
            Binarize01Act(),
            *blocks,
            nn.AvgPool2d(2),
            nn.Flatten(),
            ClassifierScale(cfg.fcsize, cfg.classifier_inter,
                            cfg.num_classes),
        )

    @property
    def stem_conv(self) -> nn.Conv2d:
        return self.features[1]

    @property
    def stem_bn(self) -> nn.BatchNorm2d:
        return self.features[2]

    @property
    def blocks(self) -> list[MultiHeadBlock]:
        return list(self.features[4:4 + self.n_blocks])

    @property
    def classifier(self) -> ClassifierScale:
        return self.features[-1]

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return ttnet_imagenet_apply(self, x, stats)


@torch.no_grad()
def init_ttnet_imagenet(model: TTnetImageNet, generator: torch.Generator):
    """Torch-default init drawn from ``generator``: conv and linear weights
    and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BN weight 1, bias 0,
    running mean 0, running var 1.  Draws on the CPU, so one seed gives one
    set of weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.rand(p.shape, generator=generator,
                                   dtype=torch.float64)
                    p.copy_(u * (2 * bound) - bound)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()


def build_ttnet_imagenet(cfg: TTnetImageNetConfig, seed: int = 0,
                         device=None,
                         dtype: torch.dtype = torch.float32) -> TTnetImageNet:
    """The model in eval mode on ``device`` (the card unless the caller
    asks for the CPU), weights from ``seed``."""
    dev = resolve_device(device)
    exact_float32()
    model = TTnetImageNet(cfg)
    init_ttnet_imagenet(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()


def _nchw(x: torch.Tensor, model: TTnetImageNet) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(model.stem_conv.weight.dtype)


def stem(model: TTnetImageNet, x: torch.Tensor,
         stats: dict | None = None) -> torch.Tensor:
    """Stem on NCHW images -> {0,1} bits (NCHW)."""
    conv = model.stem_conv
    # the stem conv has a bias after BN folding (``convert/bn_fold.py``)
    if model.cfg.stem_impl == "s2d":
        h = space_to_depth_stem(x, conv.weight)
        if conv.bias is not None:
            h = h + conv.bias.view(1, -1, 1, 1)
    else:
        h = conv2d(avg_pool(x, 2), conv.weight, conv.bias, stride=2,
                   padding=3)
    return binarize01_act(batch_norm(model.stem_bn, h, stats))


def _remat_block(block: MultiHeadBlock, h: torch.Tensor,
                 stats: dict) -> torch.Tensor:
    """One training block under ``torch.utils.checkpoint``.  The backward
    runs the block again; that second forward writes its statistics into a
    throwaway dict, so every BN's running statistics are taken from the
    first forward alone and updated once.  The block's tensors are inputs
    of the checkpointed function, so the second forward sees the ones the
    first saw (the bf16 copies of ``--amp``'s ``functional_call`` are gone
    by the time the backward runs)."""
    values = dict(itertools.chain(block.named_parameters(),
                                  block.named_buffers()))
    sinks = [stats]

    def run(x, *tensors):
        return torch.func.functional_call(
            block, dict(zip(values, tensors)),
            (x, sinks.pop() if sinks else {}))
    return checkpoint(run, h, *values.values(), use_reentrant=False,
                      preserve_rng_state=False)


def ttnet_imagenet_features(model: TTnetImageNet, x: torch.Tensor,
                            stats: dict | None = None) -> torch.Tensor:
    """Everything before the classifier; ``x`` is NHWC."""
    h = stem(model, _nchw(x, model), stats)
    remat = (model.cfg.remat and stats is not None
             and torch.is_grad_enabled())
    for block in model.blocks:
        h = _remat_block(block, h, stats) if remat else block(h, stats)
    return flatten(avg_pool(h, 2))


def ttnet_imagenet_apply(model: TTnetImageNet, x: torch.Tensor,
                         stats: dict | None = None) -> torch.Tensor:
    """Full forward: NHWC images -> logits; eval, or training when
    ``stats`` is given."""
    return classifier_scale(model.classifier,
                            ttnet_imagenet_features(model, x, stats), stats)


# ---------------------------------------------------------------------------
# The VGG16-stem variant (TT_vf_19lv3_imgnet_xsmall_VGG)

@dataclasses.dataclass(frozen=True)
class TTnetVGGStemConfig:
    num_classes: int = 1000
    image_size: int = 224
    classifier_inter: int = 1000
    p: int = 64

    def block_config(self) -> MultiHeadConfig:
        """The xsmall block with the ``x == 11`` fixup row and no fuse
        head: it returns the raw 4-head concat."""
        return MultiHeadConfig(in_planes=self.p, out_planes=self.p,
                               stride=1, last=False,
                               **{**BLOCK_VARIANTS["xsmall"],
                                  "fixup": "v2small_alexnet", "fuse": False})

    def block_configs(self) -> list[MultiHeadConfig]:
        return [self.block_config()]

    def feature_shape(self) -> tuple[int, int, int]:
        """(H, W, C) entering the flatten: 224 -> 56 (AvgPool 4; the convs
        keep the size) -> 11 (MaxPool 5) -> 12 (the block's fixup pads)."""
        s = self.image_size // 4 // 5
        h, w = multihead_out_size(self.block_config(), s, s)
        return h, w, self.block_config().out_channels

    @property
    def fcsize(self) -> int:
        h, w, c = self.feature_shape()
        return h * w * c


class TTnetVGGStem(nn.Module):
    """The reference module tree (``convert/torch_import.py:215-240``):
    ``features`` = [AvgPool, conv, ReLU, conv, ReLU, BN, MaxPool, act,
    block, Flatten, Classifier_scale]."""

    def __init__(self, cfg: TTnetVGGStemConfig):
        super().__init__()
        self.cfg = cfg
        self.features = nn.Sequential(
            nn.AvgPool2d(4),
            nn.Conv2d(3, 64, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(64, 64, 3, padding=1),
            nn.ReLU(),
            nn.BatchNorm2d(64),
            nn.MaxPool2d(5),
            Binarize01Act(),
            MultiHeadBlock(cfg.block_config()),
            nn.Flatten(),
            ClassifierScale(cfg.fcsize, cfg.classifier_inter,
                            cfg.num_classes),
        )

    @property
    def stem_conv(self) -> nn.Conv2d:
        """The first conv: its weight sets the forward's float dtype."""
        return self.features[1]

    @property
    def stem_conv2(self) -> nn.Conv2d:
        return self.features[3]

    @property
    def stem_bn(self) -> nn.BatchNorm2d:
        return self.features[5]

    @property
    def blocks(self) -> list[MultiHeadBlock]:
        return [self.features[8]]

    @property
    def classifier(self) -> ClassifierScale:
        return self.features[-1]

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return ttnet_vgg_stem_apply(self, x, stats)


def build_ttnet_vgg_stem(cfg: TTnetVGGStemConfig, seed: int = 0,
                         device=None,
                         dtype: torch.dtype = torch.float32) -> TTnetVGGStem:
    """The model in eval mode on ``device`` (the card unless the caller
    asks for the CPU), weights from ``seed``.  The stem's convs are random
    too, as in the JAX package: no pretrained VGG16 weights are fetched."""
    dev = resolve_device(device)
    exact_float32()
    model = TTnetVGGStem(cfg)
    init_ttnet_imagenet(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()


def vgg_stem(model: TTnetVGGStem, x: torch.Tensor,
             stats: dict | None = None) -> torch.Tensor:
    """The float stem on NCHW images -> {0,1} bits (NCHW, 11x11 at 224):
    AvgPool(4) -> conv3x3 + bias -> ReLU -> conv3x3 + bias -> ReLU -> BN
    -> MaxPool(5) -> Heaviside."""
    c1, c2 = model.stem_conv, model.stem_conv2
    h = avg_pool(x, 4)
    h = torch.relu(conv2d(h, c1.weight, c1.bias, padding=1))
    h = torch.relu(conv2d(h, c2.weight, c2.bias, padding=1))
    h = batch_norm(model.stem_bn, h, stats)
    return binarize01_act(max_pool(h, 5))


def ttnet_vgg_stem_apply(model: TTnetVGGStem, x: torch.Tensor,
                         stats: dict | None = None) -> torch.Tensor:
    """Forward (``ttnet_imagenet.py:259``): NHWC images -> logits; eval, or
    training when ``stats`` is given (the stem BN, the block and the
    classifier take their batch statistics, as in the JAX package)."""
    h = model.blocks[0](vgg_stem(model, _nchw(x, model), stats), stats)
    return classifier_scale(model.classifier, flatten(h), stats)
