"""The CIFAR/MNIST TTnet family (counterpart of
``scale_imagenet_tpu/models/ttnet_cifar.py:1-583``): the resnet cell, which
the v1 ImageNet and TT_general families build on too, ``mobilenet_v2_tt``
and its head-pruning ablations, ``model_general``, ``mobilenet_v1_tt`` and
``cifar10lownoise``, with the interval forwards of the last two
(``ttnet_cifar.py:585-788``).

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

from ..device import exact_float32, resolve_device
from ..layers.conv import BinConv2d, bin_conv2d, conv2d
from ..layers.linear import BinLinear, bin_linear, linear
from ..layers.norm import StatsBN, batch_norm, bn_scale_bias, stats_bn
from ..layers.pool import avg_pool, flatten, max_pool
from ..ops.binarize import binarize01_act
from ..ops.gelu import gelu
from ..ops.quantize import activation_quantize, input_quantize, ste_round
from ..ops.weights import binarize_weights, init_weight_mask
from ..robust.interval import Interval, interval_batch_norm, \
    interval_bin_linear_pos, interval_conv2d, interval_flatten, \
    interval_from_eps_ball, interval_heaviside, interval_linear, \
    interval_mono, interval_struct
from ..robust.multisample import multi_sample_heaviside, \
    multi_sample_pack, multi_sample_unpack_natural
from .multihead import channel_interleave
from .ttnet_imagenet import init_ttnet_imagenet


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


# ---------------------------------------------------------------------------
# shared by the zoo models: layout, init and build


def nchw(x: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """NHWC images -> NCHW in the model's parameter dtype."""
    return x.permute(0, 3, 1, 2).to(next(model.parameters()).dtype)


@torch.no_grad()
def init_zoo(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init distributions, drawn on the CPU from
    ``generator``: torch's default for the float convs, Linears and stock
    BNs (``init_ttnet_imagenet``), then binarized weights N(0, 0.01) and
    their masks |N(0, weight_mask_std)| (``conv.py:88``), ``StatsBN``
    weight 1 and everything else 0."""
    init_ttnet_imagenet(model, generator)
    for m in model.modules():
        if isinstance(m, (BinConv2d, BinLinear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                       dtype=torch.float64) * 0.01)
            if m.weight_mask is not None:
                m.weight_mask.copy_(init_weight_mask(
                    m.weight.shape, generator, torch.float64))
        elif isinstance(m, StatsBN):
            m.weight.fill_(1.0)
            for t in (m.bias, m.running_mean, m.running_var):
                t.zero_()


def build_zoo(model: nn.Module, seed: int, device, dtype: torch.dtype,
              init=init_zoo) -> nn.Module:
    """``model`` initialised from ``seed`` by ``init``, in eval mode on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    exact_float32()
    init(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()


# ---------------------------------------------------------------------------
# the CIFAR multi-head block (``ttnet_cifar.py:98-213``)

# head spec: ("conv", k, pad, group divisor) | ("maxpool",)
V2_HEADS = {
    "mobilenet_v2": (("conv", 4, 1, 2), ("conv", 3, 1, 3), ("conv", 2, 0, 6),
                     ("maxpool",)),
    "small": (("conv", 4, 1, 1), ("maxpool",)),
    "small_n64": (("conv", 4, 1, 2), ("conv", 2, 0, 8)),
    "small_n64bis": (("conv", 4, 1, 2), ("maxpool",)),
    "32_64": (("conv", 4, 1, 2), ("conv", 2, 0, 8)),
    "32_32": (("conv", 4, 1, 1), ("conv", 2, 0, 4)),
}
_V2_CONVF_GROUP_DIV = {
    "mobilenet_v2": 8, "small": 4, "small_n64": 8, "small_n64bis": 8,
    "32_64": 8, "32_32": 4,
}
# the TT_50 pair keeps the stem at stride 1
_V2_STEM_STRIDE = {"32_64": 1, "32_32": 1}


@dataclasses.dataclass(frozen=True)
class CifarMultiHeadConfig:
    in_planes: int
    out_planes: int
    stride: int = 1
    last: bool = False
    variant: str = "mobilenet_v2"

    @property
    def heads(self) -> tuple:
        return V2_HEADS[self.variant]

    @property
    def cpt(self) -> int:
        return len(self.heads)

    def head_cfgs(self) -> dict:
        """The conv heads by spec index."""
        return {i: BlockResnetConfig(
            self.in_planes, self.in_planes, k=spec[1], padding=spec[2],
            stride=self.stride, groupsici=self.in_planes // spec[3])
            for i, spec in enumerate(self.heads) if spec[0] == "conv"}

    def convf_cfg(self) -> BlockResnetConfig:
        cin = self.cpt * self.in_planes
        gdiv = _V2_CONVF_GROUP_DIV[self.variant]
        return BlockResnetConfig(cin, self.out_planes, k=2, padding=1,
                                 stride=1, groupsici=cin // gdiv, last=True)


class CifarMultiHead(nn.Module):
    """Conv heads ``conv{i + 1}`` (i the spec index) and ``convf``."""

    def __init__(self, cfg: CifarMultiHeadConfig):
        super().__init__()
        self.cfg = cfg
        for i, hcfg in cfg.head_cfgs().items():
            self.add_module(f"conv{i + 1}", BlockResnet(hcfg))
        self.convf = BlockResnet(cfg.convf_cfg())

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return cifar_multihead(self, x, stats)


def _crop_k3(cfg: CifarMultiHeadConfig, w: int) -> bool:
    """The k = 3 head is cropped by a pixel at stride 2 for inputs of 13,
    9 or 5, and at stride 1 (``ttnet_cifar.py:163``)."""
    return (cfg.stride == 2 and w in (13, 9, 5)) or cfg.stride == 1


def cifar_multihead(block: CifarMultiHead, x: torch.Tensor,
                    stats: dict | None = None) -> torch.Tensor:
    """``ttnet_cifar.py:155``: the heads with their crop rules, the max-pool
    head (the input cropped by a pixel at stride 1), the interleave and
    the fuse head."""
    cfg = block.cfg
    crop = _crop_k3(cfg, x.shape[3])
    outs = []
    for i, spec in enumerate(cfg.heads):
        if spec[0] == "conv":
            out = block_resnet(getattr(block, f"conv{i + 1}"), x, stats)
            outs.append(out[:, :, :-1, :-1] if crop and spec[1] == 3
                        else out)
        else:
            outs.append(max_pool(x, 2) if cfg.stride == 2
                        else x[:, :, :-1, :-1])
    cat = channel_interleave(torch.cat(outs, dim=1), cfg.cpt)
    return block_resnet(block.convf, cat, stats)


def cifar_multihead_out_size(cfg: CifarMultiHeadConfig, h: int,
                             w: int) -> tuple[int, int]:
    heads = cfg.head_cfgs()
    crop = _crop_k3(cfg, w)
    sizes = {}
    for i, spec in enumerate(cfg.heads):
        if spec[0] == "conv":
            sh, sw = block_resnet_out_size(heads[i], h, w)
            sizes[i] = (sh - 1, sw - 1) if crop and spec[1] == 3 \
                else (sh, sw)
        else:
            sizes[i] = (h // 2, w // 2) if cfg.stride == 2 \
                else (h - 1, w - 1)
    first = sizes[0]
    if any(s != first for s in sizes.values()):
        raise ValueError(f"cifar multi-head mismatch: {sizes} at {h}x{w}")
    return block_resnet_out_size(cfg.convf_cfg(), *first)


# ---------------------------------------------------------------------------
# mobilenet_v2_tt and its ablations (``ttnet_cifar.py:219-316``)

# variant -> (n, t, stage list of p)
V2_STAGES = {
    "mobilenet_v2": (6, 10, lambda p: [p, (2 * p, 2), (4 * p, 2),
                                       (8 * p, 2)]),
    "small": (8, 8, lambda p: [p, (2 * p, 2), (4 * p, 2), (8 * p, 2)]),
    "small_n64": (8, 8, lambda p: [p, (2 * p, 2), (4 * p, 2), (8 * p, 2)]),
    "small_n64bis": (8, 8, lambda p: [p, (2 * p, 2), (4 * p, 2),
                                      (8 * p, 2)]),
    # both 16p stages are ``last`` (their out_planes is the last one's)
    "32_64": (8, 8, lambda p: [(2 * p, 2), 2 * p, (4 * p, 2), 4 * p,
                               (8 * p, 2), 8 * p, (16 * p, 2), 16 * p]),
    "32_32": (8, 8, lambda p: [(2 * p, 2), 2 * p, (4 * p, 2), 4 * p,
                               (8 * p, 2), 8 * p, (16 * p, 2), 16 * p]),
}


def stage_pairs(stages: list) -> list:
    """``(out_planes, stride)`` of each entry of a stage list (an int is
    stride 1)."""
    return [(s, 1) if isinstance(s, int) else tuple(s) for s in stages]


@dataclasses.dataclass(frozen=True)
class MobilenetV2TTConfig:
    variant: str = "mobilenet_v2"
    num_classes: int = 10
    image_size: int = 32

    @property
    def p(self) -> int:
        n, t, _ = V2_STAGES[self.variant]
        return n * t

    def block_configs(self) -> list[CifarMultiHeadConfig]:
        stages = stage_pairs(V2_STAGES[self.variant][2](self.p))
        last_out = stages[-1][0]
        in_planes, cfgs, last = self.p, [], False
        for out_planes, stride in stages:
            last = last or out_planes == last_out
            cfgs.append(CifarMultiHeadConfig(in_planes, out_planes, stride,
                                             last, self.variant))
            in_planes = out_planes
        return cfgs

    @property
    def stem_stride(self) -> int:
        return _V2_STEM_STRIDE.get(self.variant, 2)

    def feature_shape(self) -> tuple[int, int, int]:
        h = w = (self.image_size + 2 * 3 - 7) // self.stem_stride + 1
        c = self.p
        for cfg in self.block_configs():
            h, w = cifar_multihead_out_size(cfg, h, w)
            c = cfg.out_planes
        return h // 2, w // 2, c

    @property
    def fcsize(self) -> int:
        h, w, c = self.feature_shape()
        return h * w * c


class MobilenetV2TT(nn.Module):
    def __init__(self, cfg: MobilenetV2TTConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.p, 7, bias=False)
        self.stem_bn = nn.BatchNorm2d(cfg.p)
        blocks = cfg.block_configs()
        self.n_blocks = len(blocks)
        for i, bcfg in enumerate(blocks):
            self.add_module(f"block{i}", CifarMultiHead(bcfg))
        self.fc = nn.Linear(cfg.fcsize, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return mobilenet_v2_tt_apply(self, x, stats)


def blocks_of(model: nn.Module) -> list:
    return [getattr(model, f"block{i}") for i in range(model.n_blocks)]


def mobilenet_v2_tt_apply(model: MobilenetV2TT, x: torch.Tensor,
                          stats: dict | None = None) -> torch.Tensor:
    """``ttnet_cifar.py:300``: conv -> 2-bit quantizer -> BN, the blocks,
    AvgPool(2), Flatten, Linear."""
    conv = model.stem_conv
    h = conv2d(nchw(x, model), conv.weight, conv.bias,
               stride=model.cfg.stem_stride, padding=3)
    h = batch_norm(model.stem_bn, activation_quantize(h, 2), stats)
    for block in blocks_of(model):
        h = block(h, stats)
    return linear(flatten(avg_pool(h, 2)), model.fc.weight, model.fc.bias)


# ---------------------------------------------------------------------------
# model_general (``ttnet_cifar.py:323-454``)

_BINARIZERS = {"ter": "quant3", "bin": "ternary_mask"}


@dataclasses.dataclass(frozen=True)
class ModelGeneralConfig:
    dataset: str = "CIFAR10"         # or "MNIST"
    preprocessing_cnn: tuple = (48, 3, 2)   # (out_ch, kernel, stride=pad)
    type_weights_preprocessing: str = "ter"  # ter | bin | float
    filters: tuple = (48,)
    amplifications: tuple = (60,)
    kernelsizes: tuple = (3,)
    strides: tuple = (2,)
    paddings: tuple = (0,)
    groups: tuple = (48,)
    type_weights_final: str = "bin"  # ter | bin | float
    use_scalar_scale_last_layer: bool = True
    remove_last_bn: bool = False
    num_classes: int = 10

    @property
    def in_channels(self) -> int:
        return 1 if self.dataset == "MNIST" else 3

    @property
    def image_size(self) -> int:
        return 28 if self.dataset == "MNIST" else 32

    def feature_shape(self) -> tuple[int, int, int]:
        och, k, st = self.preprocessing_cnn
        s = (self.image_size + 2 * st - k) // st + 1
        c = och
        for f, ks, stv, pad in zip(self.filters, self.kernelsizes,
                                   self.strides, self.paddings):
            s = (s + 2 * pad - ks) // stv + 1
            c = f
        return s, s, c

    @property
    def fcsize(self) -> int:
        h, w, c = self.feature_shape()
        return h * w * c


class ModelGeneral(nn.Module):
    """``stem_conv`` (a float conv with bias, or a ``BinConv2d``),
    ``stem_bn``, ``conv{i}a``/``bn{i}a``/``conv{i}b``/``bn{i}b`` a block,
    ``fc`` (``BinLinear`` or ``nn.Linear``) and the ``StatsBN``
    ``head_bn`` unless ``remove_last_bn``."""

    def __init__(self, cfg: ModelGeneralConfig):
        super().__init__()
        self.cfg = cfg
        och, k, _ = cfg.preprocessing_cnn
        if cfg.type_weights_preprocessing == "float":
            self.stem_conv = nn.Conv2d(cfg.in_channels, och, k)
        else:
            self.stem_conv = BinConv2d(
                cfg.in_channels, och, k,
                binarizer=_BINARIZERS[cfg.type_weights_preprocessing])
        self.stem_bn = nn.BatchNorm2d(och)
        in_ch = och
        for i, (f, a, ks) in enumerate(zip(cfg.filters, cfg.amplifications,
                                           cfg.kernelsizes)):
            g = cfg.groups[i]
            self.add_module(f"conv{i}a", nn.Conv2d(in_ch, f * a, ks,
                                                   groups=g))
            self.add_module(f"bn{i}a", nn.BatchNorm2d(f * a))
            self.add_module(f"conv{i}b", nn.Conv2d(f * a, f, 1, groups=g))
            self.add_module(f"bn{i}b", nn.BatchNorm2d(f))
            in_ch = f
        if cfg.type_weights_final == "float":
            self.fc = nn.Linear(cfg.fcsize, cfg.num_classes)
        else:
            self.fc = BinLinear(cfg.fcsize, cfg.num_classes,
                                _BINARIZERS[cfg.type_weights_final])
        if not cfg.remove_last_bn:
            self.head_bn = StatsBN(cfg.num_classes,
                                   cfg.use_scalar_scale_last_layer)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return model_general_apply(self, x, stats)


def model_general_apply(model: ModelGeneral, x: torch.Tensor,
                        stats: dict | None = None) -> torch.Tensor:
    """``ttnet_cifar.py:402``: the stem conv (float, or binarized without
    rounding), BN, Heaviside; per block conv -> BN -> ReLU -> 1x1 conv ->
    BN -> Heaviside; Flatten; the positive-bias binarized Linear (or a
    float one); the stats BN.  The JAX function's ``aux`` (the stats BN's
    scale and bias, for the bias regulariser) is left out, as the JAX
    registry drops it."""
    cfg = model.cfg
    _, _, st = cfg.preprocessing_cnn
    h = nchw(x, model)
    if cfg.type_weights_preprocessing == "float":
        h = conv2d(h, model.stem_conv.weight, model.stem_conv.bias,
                   stride=st, padding=st)
    else:
        h = bin_conv2d(h, model.stem_conv, stride=st, padding=st,
                       rounding=False)
    h = binarize01_act(batch_norm(model.stem_bn, h, stats))
    for i in range(len(cfg.filters)):
        g, stv, pad = cfg.groups[i], cfg.strides[i], cfg.paddings[i]
        ca, cb = getattr(model, f"conv{i}a"), getattr(model, f"conv{i}b")
        h = conv2d(h, ca.weight, ca.bias, stride=stv, padding=pad, groups=g)
        h = torch.relu(batch_norm(getattr(model, f"bn{i}a"), h, stats))
        h = conv2d(h, cb.weight, cb.bias, groups=g)
        h = binarize01_act(batch_norm(getattr(model, f"bn{i}b"), h, stats))
    h = flatten(h)
    if cfg.type_weights_final == "float":
        logits = linear(h, model.fc.weight, model.fc.bias)
    else:
        logits = bin_linear(h, model.fc, positive=True)
    if cfg.remove_last_bn:
        return logits
    return stats_bn(model.head_bn, logits, stats)


# ---------------------------------------------------------------------------
# mobilenet_v1_tt (``ttnet_cifar.py:461-519``): a chain of resnet cells


@dataclasses.dataclass(frozen=True)
class MobilenetV1TTConfig:
    n: int = 4
    t: int = 4
    num_classes: int = 10
    image_size: int = 32

    @property
    def p(self) -> int:
        return self.n * self.t

    def block_configs(self) -> list[BlockResnetConfig]:
        p = self.p
        stages = stage_pairs([p, (2 * p, 2), 2 * p, (4 * p, 2), 4 * p,
                              (8 * p, 2), 8 * p, 8 * p, 8 * p, 8 * p, 8 * p,
                              (16 * p, 2), 16 * p])
        in_planes, cfgs = p, []
        for out_planes, stride in stages:
            cfgs.append(BlockResnetConfig(in_planes, out_planes,
                                          stride=stride))
            in_planes = out_planes
        return cfgs


class MobilenetV1TT(nn.Module):
    def __init__(self, cfg: MobilenetV1TTConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.p, 7, bias=False)
        self.stem_bn = nn.BatchNorm2d(cfg.p)
        blocks = cfg.block_configs()
        self.n_blocks = len(blocks)
        for i, bcfg in enumerate(blocks):
            self.add_module(f"block{i}", BlockResnet(bcfg))
        self.fc = nn.Linear(16 * cfg.p, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return mobilenet_v1_tt_apply(self, x, stats)


def mobilenet_v1_tt_apply(model: MobilenetV1TT, x: torch.Tensor,
                          stats: dict | None = None) -> torch.Tensor:
    """``ttnet_cifar.py:504``: conv (stride 1) -> BN -> Heaviside, the
    cells with a Heaviside between two, AvgPool(2), Flatten, Linear."""
    conv = model.stem_conv
    h = conv2d(nchw(x, model), conv.weight, conv.bias, padding=3)
    h = binarize01_act(batch_norm(model.stem_bn, h, stats))
    blocks = blocks_of(model)
    for i, block in enumerate(blocks):
        h = block(h, stats)
        if i != len(blocks) - 1:
            h = binarize01_act(h)
    return linear(flatten(avg_pool(h, 2)), model.fc.weight, model.fc.bias)


# ---------------------------------------------------------------------------
# cifar10lownoise (``ttnet_cifar.py:527-582``)


@dataclasses.dataclass(frozen=True)
class Cifar10LowNoiseConfig:
    quant_step: float = 0.0625
    nchannel: int = 3
    num_classes: int = 10   # 200 for Tiny-ImageNet
    image_size: int = 32


class Cifar10LowNoise(nn.Module):
    def __init__(self, cfg: Cifar10LowNoiseConfig):
        super().__init__()
        self.cfg = cfg
        self.bn0 = nn.BatchNorm2d(cfg.nchannel)
        self.conv1 = BinConv2d(3, 48, 3, binarizer="quant3")
        self.conv2 = nn.Conv2d(48, 48 * 60, 3, groups=48)
        self.bn2 = nn.BatchNorm2d(48 * 60)
        self.conv3 = nn.Conv2d(48 * 60, 48, 1, groups=48)
        self.bn3 = nn.BatchNorm2d(48)
        # 32 -> 15 -> 7: 7 * 7 * 48 features
        self.fc = BinLinear(2352, cfg.num_classes, "ternary_mask")
        self.head_bn = StatsBN(cfg.num_classes, use_scalar_scale=True)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return cifar10lownoise_apply(self, x, stats)


def cifar10lownoise_apply(model: Cifar10LowNoise, x: torch.Tensor,
                          stats: dict | None = None) -> torch.Tensor:
    """``ttnet_cifar.py:562``: the input quantized to multiples of
    ``quant_step``, BN, the 2-bit quantizer, the quant3 conv (stride 2),
    Heaviside, the amplifying grouped conv -> BN -> ReLU -> 1x1 grouped
    conv -> BN -> Heaviside, Flatten, the positive-bias binarized Linear
    and the scalar-scale stats BN (its ``aux`` left out)."""
    h = input_quantize(nchw(x, model), model.cfg.quant_step)
    h = activation_quantize(batch_norm(model.bn0, h, stats), 2)
    h = binarize01_act(bin_conv2d(h, model.conv1, stride=2, rounding=False))
    h = conv2d(h, model.conv2.weight, model.conv2.bias, stride=2, groups=48)
    h = torch.relu(batch_norm(model.bn2, h, stats))
    h = conv2d(h, model.conv3.weight, model.conv3.bias, groups=48)
    h = binarize01_act(batch_norm(model.bn3, h, stats))
    logits = bin_linear(flatten(h), model.fc, positive=True)
    return stats_bn(model.head_bn, logits, stats)



# ---------------------------------------------------------------------------
# certified-robustness forwards of cifar10lownoise and model_general
# (``ttnet_cifar.py:585-788``; the reference's
# compute_act_stabilizing_loss_abstract / forward_with_multi_sample,
# netbin.py:703-738): NHWC images in, the bounds NCHW inside


def _ball(model: nn.Module, x: torch.Tensor, eps, inputs_min,
          inputs_max) -> Interval:
    """The clipped eps-ball around the NHWC images, as NCHW bounds in the
    model's dtype."""
    iv = interval_from_eps_ball(x, eps, inputs_min, inputs_max)
    return interval_struct(iv, lambda v: nchw(v, model))


def _bin_weight(layer: nn.Module) -> torch.Tensor:
    return binarize_weights(layer.binarizer, layer.weight, layer.weight_mask)


def cifar10lownoise_interval(model: Cifar10LowNoise, x: torch.Tensor, eps,
                             inputs_min=0.0, inputs_max=1.0) -> Interval:
    """The interval forward through the features, up to and including the
    last Heaviside (the reference's AbstractTensor walk over
    ``features[:-2]``): the feature ``Interval``."""
    iv = _ball(model, x, eps, inputs_min, inputs_max)
    iv = interval_mono(iv, lambda v: input_quantize(v, model.cfg.quant_step))
    iv = interval_batch_norm(iv, *bn_scale_bias(model.bn0))
    iv = interval_mono(iv, lambda v: activation_quantize(v, 2))
    iv = interval_heaviside(interval_conv2d(iv, _bin_weight(model.conv1),
                                            stride=2))
    iv = interval_conv2d(iv, model.conv2.weight, stride=2, groups=48,
                         bias=model.conv2.bias)
    iv = interval_mono(interval_batch_norm(iv, *bn_scale_bias(model.bn2)),
                       torch.relu)
    iv = interval_conv2d(iv, model.conv3.weight, groups=48,
                         bias=model.conv3.bias)
    return interval_heaviside(interval_batch_norm(
        iv, *bn_scale_bias(model.bn3)))


def cifar10lownoise_interval_loss(model: Cifar10LowNoise, x: torch.Tensor,
                                  eps, inputs_min=0.0,
                                  inputs_max=1.0) -> torch.Tensor:
    """The activation-stability loss of the interval forward
    (compute_act_stabilizing_loss_abstract, netbin.py:726-738)."""
    return cifar10lownoise_interval(model, x, eps, inputs_min,
                                    inputs_max).loss


def cifar10lownoise_interval_logits(model: Cifar10LowNoise, x: torch.Tensor,
                                    eps, inputs_min=0.0,
                                    inputs_max=1.0) -> Interval:
    """Sound logit bounds under the clipped eps-ball: the interval features
    through the BinLinearPos head, its rounding and the stats BN."""
    iv = interval_flatten(cifar10lownoise_interval(model, x, eps, inputs_min,
                                                   inputs_max))
    iv = interval_mono(interval_bin_linear_pos(iv, _bin_weight(model.fc)),
                       ste_round)
    return interval_batch_norm(iv, *bn_scale_bias(model.head_bn))


def cifar10lownoise_multi_sample(model: Cifar10LowNoise, x: torch.Tensor,
                                 x_adv: torch.Tensor, eps, key,
                                 training: bool = True):
    """``forward_with_multi_sample`` written out for this model
    (netbin.py:710-724): ``(logits of the x_adv group, stability loss)``.
    The BN statistics of the packed batch normalise in training and are
    dropped, as in the JAX function; ``key.child(0)`` draws the signs."""
    k, data = multi_sample_pack(x, x_adv, eps, key.child(0))
    stats = {} if training else None
    loss = torch.zeros((), dtype=x.dtype, device=x.device)
    h = input_quantize(nchw(data, model), model.cfg.quant_step)
    h = activation_quantize(batch_norm(model.bn0, h, stats), 2)
    h, loss = multi_sample_heaviside(
        bin_conv2d(h, model.conv1, stride=2, rounding=False), k, loss)
    h = conv2d(h, model.conv2.weight, model.conv2.bias, stride=2, groups=48)
    h = torch.relu(batch_norm(model.bn2, h, stats))
    h = conv2d(h, model.conv3.weight, model.conv3.bias, groups=48)
    h, loss = multi_sample_heaviside(batch_norm(model.bn3, h, stats), k,
                                     loss)
    logits = bin_linear(flatten(h), model.fc, positive=True)
    logits = stats_bn(model.head_bn, logits, stats)
    return multi_sample_unpack_natural(logits, k), loss


def model_general_interval(model: ModelGeneral, x: torch.Tensor, eps,
                           inputs_min=0.0, inputs_max=1.0) -> Interval:
    """The interval forward of ``model_general`` through the features, up
    to and including the last Heaviside: the feature ``Interval``."""
    cfg = model.cfg
    _, _, st = cfg.preprocessing_cnn
    iv = _ball(model, x, eps, inputs_min, inputs_max)
    stem = model.stem_conv
    if cfg.type_weights_preprocessing == "float":
        iv = interval_conv2d(iv, stem.weight, stride=st, padding=st,
                             bias=stem.bias)
    else:
        iv = interval_conv2d(iv, _bin_weight(stem), stride=st, padding=st)
    iv = interval_heaviside(interval_batch_norm(
        iv, *bn_scale_bias(model.stem_bn)))
    for i in range(len(cfg.filters)):
        g, stv, pad = cfg.groups[i], cfg.strides[i], cfg.paddings[i]
        ca, cb = getattr(model, f"conv{i}a"), getattr(model, f"conv{i}b")
        iv = interval_conv2d(iv, ca.weight, stride=stv, padding=pad,
                             groups=g, bias=ca.bias)
        iv = interval_mono(interval_batch_norm(
            iv, *bn_scale_bias(getattr(model, f"bn{i}a"))), torch.relu)
        iv = interval_conv2d(iv, cb.weight, groups=g, bias=cb.bias)
        iv = interval_heaviside(interval_batch_norm(
            iv, *bn_scale_bias(getattr(model, f"bn{i}b"))))
    return iv


def model_general_interval_loss(model: ModelGeneral, x: torch.Tensor, eps,
                                inputs_min=0.0,
                                inputs_max=1.0) -> torch.Tensor:
    """The activation-stability loss of the interval forward."""
    return model_general_interval(model, x, eps, inputs_min,
                                  inputs_max).loss


def model_general_interval_logits(model: ModelGeneral, x: torch.Tensor, eps,
                                  inputs_min=0.0,
                                  inputs_max=1.0) -> Interval:
    """Sound logit bounds under the clipped eps-ball: the interval features
    through the classifier (a float Linear, or BinLinearPos with its
    rounding) and the stats BN unless ``remove_last_bn``."""
    iv = interval_flatten(model_general_interval(model, x, eps, inputs_min,
                                                 inputs_max))
    if model.cfg.type_weights_final == "float":
        iv = interval_linear(iv, model.fc.weight, linear, bias=model.fc.bias)
    else:
        iv = interval_mono(interval_bin_linear_pos(iv, _bin_weight(model.fc)),
                           ste_round)
    if model.cfg.remove_last_bn:
        return iv
    return interval_batch_norm(iv, *bn_scale_bias(model.head_bn))
