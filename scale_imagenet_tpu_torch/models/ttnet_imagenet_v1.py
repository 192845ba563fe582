"""The v1 ImageNet TTnet family (counterpart of
``scale_imagenet_tpu/models/ttnet_imagenet_v1.py``; the reference's
``TT_general_imagenet.py``).

The heads are ``Block_resnet_BN`` cells: conv(k, t = 8, groups) -> BN ->
GELU -> 1x1 grouped conv -> BN -> the 2-bit activation quantizer
(``a_bit``; the Heaviside at ``a_bit = 1``), or a GELU in the fuse head,
which is a k = 2 pad 1 cell with ``last``: the blocks chain continuous
values, ``in_planes = out_planes``.  Head 4 is ZeroPad2d(1) + AvgPool2d(2)
at stride 2 and the identity at stride 1.  The heads' sizes are reconciled
by each variant's exact table (``_fixups_v1``: crops of one pixel at the
bottom right, or one-pixel pads at the top left), then by a generic
bottom-right crop to the smallest head where no table row applies (the
JAX package's rule for the three ablation models that crash as shipped at
224).

The model: AvgPool(2) -> conv 7x7 s2 p3 -> BN -> Heaviside -> the stage
list of ``V1_STAGES`` -> AvgPool(2) -> Flatten -> Linear.  The module tree
is the one ``convert/torch_import.py::import_ttnet_v1`` reads
(``torch_import.py:424-445``): ``features.1`` the stem conv, ``.2`` its BN,
``.3`` the activation, ``.{4+i}`` the blocks (``Block_conv{1,2,3}``,
``Block_convf``, each with ``conv1``/``bn1``/``conv2``/``bn2``), the
Linear after the pool and the flatten.  NHWC images in, logits out; eval,
or training when given ``stats``.  No table or circuit: the heads are not
Block_TT cells, and the JAX package compiles none.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import exact_float32, resolve_device
from ..layers.conv import conv2d
from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..layers.pool import avg_pool, flatten, zero_pad2d
from ..ops.binarize import Binarize01Act, binarize01_act
from ..ops.gelu import gelu
from ..ops.quantize import activation_quantize
from .multihead import channel_interleave
from .ttnet_cifar import BlockResnet, BlockResnetConfig, \
    block_resnet_out_size, first_half
from .ttnet_imagenet import _nchw, init_ttnet_imagenet


def block_resnet_bn(block: BlockResnet, x: torch.Tensor,
                    stats: dict | None = None) -> torch.Tensor:
    """``Block_resnet_BN`` (``ttnet_imagenet_v1.py:53``): the activation
    after bn2, a GELU in the last cell."""
    cfg = block.cfg
    out = batch_norm(block.bn2, first_half(block, x, stats), stats)
    if cfg.last:
        return gelu(out)
    if cfg.a_bit > 1:
        return activation_quantize(out, cfg.a_bit)
    return binarize01_act(out)


# variant -> head kernels and pads, group divisors, the fuse head's
# divisor and the fixup table (``ttnet_imagenet_v1.py:76-97``); ``heads``
# lists the conv heads (head 4 is always there)
V1_VARIANTS = {
    "vf_imgnet": dict(ks=(7, 4, 2), pads=(3, 2, 1), groupvf=8,
                      groups=(1, 2, 4), fixup="imgnet"),
    "vf_small_imgnet": dict(ks=(4, 3, 2), pads=(2, 1, 1), groupvf=4,
                            groups=(1, 2, 4)),
    "vf_smallv2_imgnet": dict(ks=(4, 3, 2), pads=(2, 1, 1), groupvf=4,
                              groups=(1, 2, 4)),
    "vf_64": dict(ks=(8, 4, 2), pads=(4, 2, 1), groupvf=12,
                  groups=(1, 2, 4)),
    "vf_17l": dict(ks=(7, 4, 2), pads=(3, 2, 1), groupvf=8,
                   groups=(1, 2, 4), fixup="17l"),
    "vf_pad": dict(ks=(7, 4, 2), pads=(3, 2, 1), groupvf=8,
                   groups=(1, 2, 4), fixup="pad"),
    "vf_7x": dict(ks=(7,), pads=(3,), groupvf=8, groups=(1,),
                  heads=(1,), fixup="7x"),
}


def _fixups_v1(fixup: str | None, stride: int, xw: int) -> tuple:
    """The variants' exact tables (``ttnet_imagenet_v1.py:100-127``):
    ``(heads cropped by one pixel at the bottom right, heads padded by one
    at the top left)``."""
    if fixup == "imgnet":
        return ((2, 3) if xw in (56, 30, 16) else ()), ()
    if fixup == "17l":
        if stride == 1 or (stride == 2 and xw in (16, 13, 10, 6)):
            return (2, 3, 4), ()
        return (), ()
    if fixup == "pad":
        if stride == 1 and xw in (8, 14, 9, 11, 12, 20, 18, 16):
            return (), (1, 4)
        if xw in (18, 14, 20) or (stride == 2 and xw in (10, 6)):
            return (), (1,)
        return (), ()
    if fixup == "7x":
        if stride == 2 and xw in (10, 6):
            return (4,), ()
        return (), ()
    return (), ()


@dataclasses.dataclass(frozen=True)
class V1MultiHeadConfig:
    in_planes: int
    out_planes: int
    stride: int = 1
    a_bit: int = 2
    variant: str = "vf_imgnet"

    @property
    def spec(self) -> dict:
        return V1_VARIANTS[self.variant]

    @property
    def conv_heads(self) -> tuple:
        return self.spec.get("heads", (1, 2, 3))

    @property
    def cpt(self) -> int:
        return len(self.conv_heads) + 1          # and the pool/identity head

    def head_cfgs(self) -> dict:
        s = self.spec
        return {h: BlockResnetConfig(
            self.in_planes, self.in_planes, k=s["ks"][j], a=8,
            padding=s["pads"][j], stride=self.stride,
            groupsici=self.in_planes // s["groups"][j], a_bit=self.a_bit)
            for j, h in enumerate(self.conv_heads)}

    def convf_cfg(self) -> BlockResnetConfig:
        """The k = 2 fuse head; ``int(cin / groupvf)`` groups stepped down
        to a divisor of both channel counts (``ttnet_imagenet_v1.py:159``:
        vf_64's 5 groups on 64 channels crash the reference too)."""
        cin = self.cpt * self.in_planes
        g = max(cin // self.spec["groupvf"], 1)
        while g > 1 and (cin % g or self.out_planes % g):
            g -= 1
        return BlockResnetConfig(cin, self.out_planes, k=2, a=8, padding=1,
                                 stride=1, groupsici=g, last=True,
                                 a_bit=self.a_bit)


class V1MultiHeadBlock(nn.Module):
    """Heads under the reference names ``Block_conv{i}`` and
    ``Block_convf``."""

    def __init__(self, cfg: V1MultiHeadConfig):
        super().__init__()
        self.cfg = cfg
        for i, hcfg in cfg.head_cfgs().items():
            self.add_module(f"Block_conv{i}", BlockResnet(hcfg))
        self.Block_convf = BlockResnet(cfg.convf_cfg())

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return v1_multihead(self, x, stats)


def v1_multihead(block: V1MultiHeadBlock, x: torch.Tensor,
                 stats: dict | None = None) -> torch.Tensor:
    """``ttnet_imagenet_v1.py:180``: the heads, head 4, the fixups, the
    generic reconcile, the interleave and the fuse head."""
    cfg = block.cfg
    outs = {i: block_resnet_bn(getattr(block, f"Block_conv{i}"), x, stats)
            for i in cfg.conv_heads}
    outs[4] = avg_pool(zero_pad2d(x, (1, 1, 1, 1)), 2) if cfg.stride == 2 \
        else x
    crops, pads = _fixups_v1(cfg.spec.get("fixup"), cfg.stride, x.shape[3])
    for i in crops:
        outs[i] = outs[i][:, :, :-1, :-1]
    for i in pads:
        outs[i] = zero_pad2d(outs[i], (1, 0, 1, 0))
    # the generic reconcile: a bottom-right crop to the smallest head
    th = min(o.shape[2] for o in outs.values())
    tw = min(o.shape[3] for o in outs.values())
    cat = torch.cat([outs[i][:, :, :th, :tw] for i in sorted(outs)], dim=1)
    return block_resnet_bn(block.Block_convf,
                           channel_interleave(cat, cfg.cpt), stats)


def v1_multihead_out_size(cfg: V1MultiHeadConfig, h: int,
                          w: int) -> tuple[int, int]:
    heads = cfg.head_cfgs()
    sizes = {i: block_resnet_out_size(heads[i], h, w)
             for i in cfg.conv_heads}
    sizes[4] = ((h + 2) // 2, (w + 2) // 2) if cfg.stride == 2 else (h, w)
    crops, pads = _fixups_v1(cfg.spec.get("fixup"), cfg.stride, w)
    for i in crops:
        sizes[i] = (sizes[i][0] - 1, sizes[i][1] - 1)
    for i in pads:
        sizes[i] = (sizes[i][0] + 1, sizes[i][1] + 1)
    th = min(s[0] for s in sizes.values())
    tw = min(s[1] for s in sizes.values())
    return block_resnet_out_size(cfg.convf_cfg(), th, tw)


# the stage tables (``ttnet_imagenet_v1.py:250-283``): an int is
# ``out_planes`` at stride 1, a pair ``(out_planes, stride)``
V1_STAGES = {
    "TT_vf_19lv2_imgnet": ("vf_imgnet",
                           lambda p: [p, (2 * p, 2), 2 * p, (4 * p, 2),
                                      (8 * p, 2)]),
    "TT_general_vf": ("vf_imgnet",
                      lambda p: [p, (2 * p, 2), (4 * p, 2), (8 * p, 2)]),
    "TT_vf_smallv2_imgnet": ("vf_smallv2_imgnet",
                             lambda p: [p, (2 * p, 2), (4 * p, 2),
                                        (8 * p, 2)]),
    "TT_vf_small_imgnet": ("vf_small_imgnet",
                           lambda p: [p, (2 * p, 2), 2 * p, (4 * p, 2),
                                      4 * p, (8 * p, 2)]),
    "TT_vf_64bit": ("vf_64",
                    lambda p: [p, (2 * p, 2), (4 * p, 2), (8 * p, 2)]),
    "TT_vf_26": ("vf_imgnet",
                 lambda p: [p, (2 * p, 2), 2 * p, (4 * p, 2), 4 * p,
                            (8 * p, 2)]),
    "TT_vf_30": ("vf_imgnet",
                 lambda p: [p, (2 * p, 2), 2 * p, (4 * p, 2), 4 * p,
                            (8 * p, 2), 8 * p]),
    "TT_vf_17l": ("vf_17l",
                  lambda p: [(2 * p, 2), (4 * p, 2), (8 * p, 2)]),
    "TT_vf_unique_7_x": ("vf_7x",
                         lambda p: [p, (2 * p, 2), (4 * p, 2),
                                    (8 * p, 2)]),
    "TT_vf_18l_pad": ("vf_pad",
                      lambda p: [p, (2 * p, 2), (4 * p, 2), (8 * p, 2)]),
}


def cifar_name(name: str) -> str:
    """The registry name of a v1 model's 32x32 10-class clone
    (``scale_imagenet_tpu/models/registry.py:218-220``)."""
    return name.replace("_imgnet", "") + "_cifar" if "_imgnet" in name \
        else name + "_cifar"


@dataclasses.dataclass(frozen=True)
class TTnetV1Config:
    name: str = "TT_vf_19lv2_imgnet"
    nfilter: int = 8
    tfilter: int = 8
    num_classes: int = 1000
    image_size: int = 224
    a_bit: int = 2

    @property
    def p(self) -> int:
        return self.nfilter * self.tfilter

    def block_configs(self) -> list[V1MultiHeadConfig]:
        variant, stages = V1_STAGES[self.name]
        in_planes, cfgs = self.p, []
        for s in stages(self.p):
            out_planes, stride = (s, 1) if isinstance(s, int) else s
            cfgs.append(V1MultiHeadConfig(in_planes, out_planes,
                                          stride=stride, a_bit=self.a_bit,
                                          variant=variant))
            in_planes = out_planes
        return cfgs

    def feature_shape(self) -> tuple[int, int, int]:
        """(H, W, C) entering the flatten."""
        s = self.image_size // 2            # AvgPool2d(2)
        h = w = (s + 6 - 7) // 2 + 1        # the 7x7 s2 p3 stem conv
        c = self.p
        for cfg in self.block_configs():
            h, w = v1_multihead_out_size(cfg, h, w)
            c = cfg.out_planes
        return h // 2, w // 2, c            # AvgPool2d(2)

    @property
    def fcsize(self) -> int:
        h, w, c = self.feature_shape()
        return h * w * c


class TTnetV1(nn.Module):
    def __init__(self, cfg: TTnetV1Config):
        super().__init__()
        self.cfg = cfg
        blocks = [V1MultiHeadBlock(b) for b in cfg.block_configs()]
        self.n_blocks = len(blocks)
        self.features = nn.Sequential(
            nn.AvgPool2d(2),
            nn.Conv2d(3, cfg.p, 7, stride=2, padding=3, bias=False),
            nn.BatchNorm2d(cfg.p),
            Binarize01Act(),
            *blocks,
            nn.AvgPool2d(2),
            nn.Flatten(),
            nn.Linear(cfg.fcsize, cfg.num_classes),
        )

    @property
    def stem_conv(self) -> nn.Conv2d:
        return self.features[1]

    @property
    def stem_bn(self) -> nn.BatchNorm2d:
        return self.features[2]

    @property
    def blocks(self) -> list[V1MultiHeadBlock]:
        return list(self.features[4:4 + self.n_blocks])

    @property
    def fc(self) -> nn.Linear:
        return self.features[-1]

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return ttnet_v1_apply(self, x, stats)


def ttnet_v1_features(model: TTnetV1, x: torch.Tensor,
                      stats: dict | None = None) -> torch.Tensor:
    """Everything before the Linear; ``x`` is NHWC."""
    conv = model.stem_conv
    h = conv2d(avg_pool(_nchw(x, model), 2), conv.weight, conv.bias,
               stride=2, padding=3)
    h = binarize01_act(batch_norm(model.stem_bn, h, stats))
    for block in model.blocks:
        h = block(h, stats)
    return flatten(avg_pool(h, 2))


def ttnet_v1_apply(model: TTnetV1, x: torch.Tensor,
                   stats: dict | None = None) -> torch.Tensor:
    """NHWC images -> logits (``ttnet_imagenet_v1.py:339``)."""
    return linear(ttnet_v1_features(model, x, stats), model.fc.weight,
                  model.fc.bias)


def build_ttnet_v1(cfg: TTnetV1Config, seed: int = 0, device=None,
                   dtype: torch.dtype = torch.float32) -> TTnetV1:
    """The model in eval mode on ``device`` (the card unless the caller
    asks for the CPU), torch-default weights from ``seed``."""
    dev = resolve_device(device)
    exact_float32()
    model = TTnetV1(cfg)
    init_ttnet_imagenet(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()
