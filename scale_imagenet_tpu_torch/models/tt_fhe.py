"""The TT_FHE CIFAR family (counterpart of ``scale_imagenet_tpu/models/tt_fhe.py``).

The models of ``FHE_MODELS``, one config over one implementation:

* ``TT_FHE_SMALL``: conv5 s2 p2 stem -> BN -> Heaviside -> one ``fhe_v3``
  block (k = 2 heads, groups [1, 1, 4, 1], fuse head to 4·p) -> MaxPool(2)
  -> Flatten -> Linear(no bias) -> BN -> Linear(no bias) -> BN;
* ``TT_FHE_XSMALL``: the same stem, a block that returns its raw 4-head
  concat (no fuse head), MaxPool(2), ``Classifier_scale`` without the
  polynomial;
* ``TT_FHE_ref``: the stem-only ablation (no block);
* ``TT_FHE_SMALL_polyhead``: ``TT_FHE_SMALL`` with the
  ``Classifier_scale_new`` split head;
* ``TT_FHE_SMALL_bireal``: ``TT_FHE_SMALL`` with the Bi-Real sign stem
  activation (its outputs are not bits: no tables or circuit);
* ``TT_FHE_small``: conv3 s2 p1 stem -> BN -> the dead-zone Heaviside
  (T = 0.03) -> one ``fhe_v2`` block ((3,2)/(2,3) heads, groups [1, 1, 6,
  1] stepped down at p = 64 as the JAX package does, fuse head to p; every
  head and the fuse head with T = 0.1) -> AvgPool(2) -> Flatten ->
  Linear -> BN -> Linear, both linears with a bias (the "plain"
  classifier).  Its forward is stochastic, in eval too: each dead zone
  draws its coin flips from the ``NoiseKey`` the caller gives, the stem
  from ``noise.child("stem")`` and block i from ``noise.child(i)``, as
  the JAX package splits its key (``tt_fhe.py:174-192``).  No table or
  circuit represents it (the JAX package refuses them too).

``TT_FHE_XSMALL_vAlexnet`` (``TTFHEAlexnetConfig``): VGG16 conv1 (3x3, bias)
-> ReLU -> BN -> MaxPool(3) -> Heaviside -> that file's own block ((3,2)/
(2,3) depthwise heads, head 3 at 8 channels a group, the raw concat) ->
Flatten -> ``Classifier_scale`` without the polynomial.

The module trees are the reference's ``features`` Sequentials, under the
keys ``convert/torch_export.py::export_tt_fhe`` writes (``torch_export.py:
88-150``): ``features.0`` the stem conv, ``.1`` its BN, ``.2`` the stem
activation, ``.3…`` the blocks (no block-level activation), then the pool,
the flatten and the classifier, as flat Linear/BN entries (``two_bn``), a
``Classifier_scale`` submodule (``scale``: ``lin1``/``BN2``/``lin2``) or a
``Classifier_scale_new`` one (``scale_new``: ``linvf``...).

The public forwards take NHWC images and return logits, in eval, or in
training when given ``stats`` (batch statistics in every BN, as
``models/ttnet_imagenet.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import exact_float32, resolve_device
from ..layers.conv import conv2d
from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..layers.pool import avg_pool, flatten, max_pool
from ..ops.binarize import Binarize01Act, BinaryActivation, NoiseKey, \
    binarize01_act, bireal_act
from .classifier import ClassifierScale, ClassifierScaleNew, \
    classifier_scale, classifier_scale_new
from .multihead import MultiHeadBlock, MultiHeadConfig, multihead_out_size
from .ttnet_imagenet import _nchw, init_ttnet_imagenet

FHE_BLOCK_VARIANTS = {
    # v3 block (TT_FHE_SMALL.py:434-488): k=2 heads, pad 1, 4x out
    "fhe_v3": dict(k12=(2, 2), pad12=(1, 1), groups=(1, 1, 4, 1),
                   groupvf=4, out_mult=4, fixup="fhe_v3"),
    # v2 block (TT_FHE.py:384-435): (3,2)/(2,3) kernels, fuse head to p;
    # the reference crashes as shipped at p = 64 (head 3: int(64/6) = 10
    # groups on 64 channels), so the groups step down (``repair_groups``)
    "fhe_v2": dict(k12=((3, 2), (2, 3)), pad12=(1, 1), groups=(1, 1, 6, 1),
                   groupvf=4, out_mult=1, fixup="fhe_v2",
                   repair_groups=True),
    # xsmall: v3 heads, raw concat output (no fuse head)
    "fhe_xsmall": dict(k12=(2, 2), pad12=(1, 1), groups=(1, 1, 4, 1),
                       groupvf=4, out_mult=4, fixup="fhe_v3", fuse=False),
    # the vAlexnet file's own v3 block: (3,2)/(2,3) depthwise heads, head 3
    # at 8 channels a group, raw concat (no fuse head)
    "fhe_valexnet": dict(k12=((3, 2), (2, 3)), pad12=(1, 1),
                         groups=(1, 1, 8, 1), groupvf=4, out_mult=4,
                         fixup="fhe_valexnet", fuse=False),
}

# ``tt_fhe.py:68-89``.  Classifier styles: "two_bn" lin(fc, inter, no
# bias) -> BN -> lin(inter, classes, no bias) -> BN; "plain" lin(fc, inter,
# bias) -> BN -> lin(inter, classes, bias); "scale" lin1 -> BN2 [-> poly]
# -> lin2 (bias); "scale_new" the split head
FHE_MODELS = {
    "TT_FHE_SMALL": dict(variant="fhe_v3", k=5, pad=2, T=0.0, T_block=0.0,
                         pool="max", classifier="two_bn", poly=False),
    "TT_FHE_small": dict(variant="fhe_v2", k=3, pad=1, T=0.03, T_block=0.1,
                         pool="avg", classifier="plain", poly=False),
    "TT_FHE_XSMALL": dict(variant="fhe_xsmall", k=5, pad=2, T=0.0,
                          T_block=0.0, pool="max", classifier="scale",
                          poly=False),
    "TT_FHE_ref": dict(variant=None, k=5, pad=2, T=0.0, T_block=0.0,
                       pool="max", classifier="scale", poly=False),
    "TT_FHE_SMALL_polyhead": dict(variant="fhe_v3", k=5, pad=2, T=0.0,
                                  T_block=0.0, pool="max",
                                  classifier="scale_new", poly=True,
                                  inter=50, non_lin=960),
    "TT_FHE_SMALL_bireal": dict(variant="fhe_v3", k=5, pad=2, T=0.0,
                                T_block=0.0, pool="max",
                                classifier="two_bn", poly=False,
                                act="bireal"),
}


@dataclasses.dataclass(frozen=True)
class TTFHEConfig:
    name: str = "TT_FHE_SMALL"
    nfilter: int = 8
    tfilter: int = 8
    num_classes: int = 10
    image_size: int = 32
    inter: int = 100

    @property
    def p(self) -> int:
        return self.nfilter * self.tfilter

    @property
    def spec(self) -> dict:
        return FHE_MODELS[self.name]

    @property
    def stochastic(self) -> bool:
        """The forward draws coin flips (a dead zone somewhere)."""
        return self.spec["T"] != 0.0 or self.spec["T_block"] != 0.0

    def block_configs(self) -> list[MultiHeadConfig]:
        variant = self.spec["variant"]
        if variant is None:
            return []
        t = self.spec["T_block"]
        return [MultiHeadConfig(in_planes=self.p, out_planes=self.p,
                                stride=1, last=False, T=t, T_convf=t,
                                **FHE_BLOCK_VARIANTS[variant])]

    def feature_shape(self) -> tuple[int, int, int]:
        """(H, W, C) entering the flatten (after the 2x2 pool)."""
        k, pad = self.spec["k"], self.spec["pad"]
        h = w = (self.image_size + 2 * pad - k) // 2 + 1
        c = self.p
        for cfg in self.block_configs():
            h, w = multihead_out_size(cfg, h, w)
            c = cfg.out_channels
        return h // 2, w // 2, c

    @property
    def fcsize(self) -> int:
        h, w, c = self.feature_shape()
        return h * w * c


def _classifier_modules(cfg: TTFHEConfig) -> list[nn.Module]:
    spec, fc = cfg.spec, cfg.fcsize
    style = spec["classifier"]
    if style == "scale_new":
        return [ClassifierScaleNew(fc, cfg.num_classes,
                                   spec.get("inter", cfg.inter),
                                   spec.get("non_lin", 960))]
    if style == "scale":
        return [ClassifierScale(fc, cfg.inter, cfg.num_classes,
                                poly=spec["poly"])]
    # "two_bn" and "plain": flat Linear, BN, Linear[, BN] entries
    bias = style == "plain"
    head = [nn.Linear(fc, cfg.inter, bias=bias), nn.BatchNorm1d(cfg.inter),
            nn.Linear(cfg.inter, cfg.num_classes, bias=bias)]
    if style == "two_bn":
        head.append(nn.BatchNorm1d(cfg.num_classes))
    return head


class TTFHE(nn.Module):
    def __init__(self, cfg: TTFHEConfig):
        super().__init__()
        self.cfg = cfg
        spec = cfg.spec
        blocks = [MultiHeadBlock(b, act=False) for b in cfg.block_configs()]
        self.n_blocks = len(blocks)
        self.features = nn.Sequential(
            nn.Conv2d(3, cfg.p, spec["k"], stride=2, padding=spec["pad"],
                      bias=False),
            nn.BatchNorm2d(cfg.p),
            BinaryActivation() if spec.get("act") == "bireal"
            else Binarize01Act(),
            *blocks,
            nn.MaxPool2d(2) if spec["pool"] == "max" else nn.AvgPool2d(2),
            nn.Flatten(),
            *_classifier_modules(cfg),
        )

    @property
    def stem_conv(self) -> nn.Conv2d:
        return self.features[0]

    @property
    def stem_bn(self) -> nn.BatchNorm2d:
        return self.features[1]

    @property
    def stem_act(self) -> nn.Module:
        return self.features[2]

    @property
    def blocks(self) -> list[MultiHeadBlock]:
        return list(self.features[3:3 + self.n_blocks])

    @property
    def classifier(self) -> list[nn.Module]:
        """The head's modules after the flatten (one submodule, or the
        flat Linear/BN entries)."""
        return list(self.features[3 + self.n_blocks + 2:])

    def forward(self, x: torch.Tensor, stats: dict | None = None,
                noise: NoiseKey | None = None) -> torch.Tensor:
        return tt_fhe_apply(self, x, stats, noise)


def tt_fhe_stem(model: TTFHE, x: torch.Tensor, stats: dict | None = None,
                noise: NoiseKey | None = None) -> torch.Tensor:
    """The float stem on NCHW images: conv (stride 2) -> BN -> Heaviside
    ({0,1} bits; with the dead zone drawn from ``noise`` when the model has
    one), or the Bi-Real activation (scaled signs)."""
    conv = model.stem_conv
    h = conv2d(x, conv.weight, conv.bias, stride=2,
               padding=model.cfg.spec["pad"])
    h = batch_norm(model.stem_bn, h, stats)
    act = model.stem_act
    if isinstance(act, BinaryActivation):
        return bireal_act(h, act.alpha_a, act.beta_a)
    return binarize01_act(h, model.cfg.spec["T"], noise)


def tt_fhe_head(model: TTFHE, h: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
    """Pool, flatten and classifier (``tt_fhe.py:197``), shared by the conv,
    LUT and gate forwards; ``h`` is NCHW in the model's dtype."""
    h = max_pool(h, 2) if model.cfg.spec["pool"] == "max" \
        else avg_pool(h, 2)
    h = flatten(h)
    head = model.classifier
    if isinstance(head[0], ClassifierScaleNew):
        return classifier_scale_new(head[0], h, stats)
    if isinstance(head[0], ClassifierScale):
        return classifier_scale(head[0], h, stats)
    lin1, bn1, lin2, *bn2 = head
    h = batch_norm(bn1, linear(h, lin1.weight, lin1.bias), stats)
    h = linear(h, lin2.weight, lin2.bias)
    return batch_norm(bn2[0], h, stats) if bn2 else h


def tt_fhe_apply(model: TTFHE, x: torch.Tensor, stats: dict | None = None,
                 noise: NoiseKey | None = None) -> torch.Tensor:
    """NHWC images -> logits (``tt_fhe.py:173``); ``noise`` keys the dead
    zones of a stochastic model (``TT_FHE_small``), which needs one."""
    keyed = noise is not None and model.cfg.stochastic
    h = tt_fhe_stem(model, _nchw(x, model), stats,
                    noise.child("stem") if keyed else None)
    for i, block in enumerate(model.blocks):
        h = block(h, stats, noise.child(i) if keyed else None)
    return tt_fhe_head(model, h, stats)


# ---------------------------------------------------------------------------
# TT_FHE_XSMALL_vAlexnet

@dataclasses.dataclass(frozen=True)
class TTFHEAlexnetConfig:
    num_classes: int = 10
    image_size: int = 32
    inter: int = 100
    maxpool: int = 3
    p: int = 64

    def block_configs(self) -> list[MultiHeadConfig]:
        return [MultiHeadConfig(in_planes=self.p, out_planes=self.p,
                                stride=1, last=False,
                                **FHE_BLOCK_VARIANTS["fhe_valexnet"])]

    @property
    def fcsize(self) -> int:
        s = self.image_size // self.maxpool
        cfg = self.block_configs()[0]
        h, w = multihead_out_size(cfg, s, s)
        return h * w * cfg.out_channels


class TTFHEAlexnet(nn.Module):
    """``features`` = [conv, ReLU, BN, MaxPool, act, block, Flatten,
    Classifier_scale] (``convert/torch_import.py:190``)."""

    def __init__(self, cfg: TTFHEAlexnetConfig):
        super().__init__()
        self.cfg = cfg
        self.features = nn.Sequential(
            nn.Conv2d(3, cfg.p, 3, padding=1),
            nn.ReLU(),
            nn.BatchNorm2d(cfg.p),
            nn.MaxPool2d(cfg.maxpool),
            Binarize01Act(),
            MultiHeadBlock(cfg.block_configs()[0], act=False),
            nn.Flatten(),
            ClassifierScale(cfg.fcsize, cfg.inter, cfg.num_classes,
                            poly=False),
        )

    @property
    def stem_conv(self) -> nn.Conv2d:
        return self.features[0]

    @property
    def stem_bn(self) -> nn.BatchNorm2d:
        return self.features[2]

    @property
    def blocks(self) -> list[MultiHeadBlock]:
        return [self.features[5]]

    @property
    def classifier(self) -> ClassifierScale:
        return self.features[7]

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return tt_fhe_alexnet_apply(self, x, stats)


def tt_fhe_alexnet_stem(model: TTFHEAlexnet, x: torch.Tensor,
                        stats: dict | None = None) -> torch.Tensor:
    """NCHW images -> {0,1} bits: conv3x3 + bias -> ReLU -> BN ->
    MaxPool(maxpool) -> Heaviside."""
    conv = model.stem_conv
    h = torch.relu(conv2d(x, conv.weight, conv.bias, padding=1))
    h = batch_norm(model.stem_bn, h, stats)
    return binarize01_act(max_pool(h, model.cfg.maxpool))


def tt_fhe_alexnet_apply(model: TTFHEAlexnet, x: torch.Tensor,
                         stats: dict | None = None) -> torch.Tensor:
    """NHWC images -> logits (``tt_fhe.py:270``)."""
    h = model.blocks[0](tt_fhe_alexnet_stem(model, _nchw(x, model), stats),
                        stats)
    return classifier_scale(model.classifier, flatten(h), stats)


def build_tt_fhe(cfg, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """A ``TTFHE`` or ``TTFHEAlexnet`` in eval mode on ``device`` (the card
    unless the caller asks for the CPU), torch-default weights from
    ``seed`` (``init_ttnet_imagenet``; the Bi-Real alpha 1 and beta 0)."""
    dev = resolve_device(device)
    exact_float32()
    model = TTFHEAlexnet(cfg) if isinstance(cfg, TTFHEAlexnetConfig) \
        else TTFHE(cfg)
    init_ttnet_imagenet(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()
