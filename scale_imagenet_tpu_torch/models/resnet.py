"""DoReFa-quantized ResNets, the dense-conv contrast baselines (counterpart
of ``scale_imagenet_tpu/models/resnet.py``): ResNet-18/34/50/101/152 at
224x224 (7x7 s2 stem, MaxPool(3, 2, 1), AvgPool(7)) and their CIFAR
variants (3x3 s1 stem, no max-pool, a global average pool).

``quan_conv``/``quan_linear`` quantize the weights (``dorefa_w``, ``wbit``)
and the activations entering them (``dorefa_a``, ``abit``) on the fly; the
stem conv stays float and the Linear runs at ``wbit = 8``.  Basic and
bottleneck blocks with a 1x1 ``down_conv``/``down_bn`` where the shape
changes.  Modules under the JAX trees' names (``layer{i}_{j}``);
``convert/fuse_quant.py`` is the fused-quant serving transform.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.conv import conv2d
from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..layers.pool import avg_pool, flatten
from ..ops.dorefa import dorefa_a, dorefa_w
from .ttnet_cifar import nchw

_STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    wbit: int = 4
    abit: int = 4
    num_classes: int = 1000
    cifar: bool = False   # 3x3 stem, no max-pool

    @property
    def block(self) -> str:
        return _STAGES[self.depth][0]

    @property
    def stage_blocks(self) -> tuple:
        return _STAGES[self.depth][1]

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4

    @property
    def image_size(self) -> int:
        """224 for every ResNet, the CIFAR clones too: the JAX CLI's
        default for a config that names no input side
        (``scale_imagenet_tpu/main.py:912``)."""
        return 224


def quan_conv(x: torch.Tensor, conv: nn.Conv2d, wbit: int, abit: int,
              stride=1, padding=0) -> torch.Tensor:
    """QuanConv (``resnet.py:33``): DoReFa weights and inputs on the fly;
    the conv's bias (present after BN folding) is added."""
    w = dorefa_w(conv.weight, wbit) if wbit < 32 else conv.weight
    if abit < 32:
        x = dorefa_a(x, abit)
    return conv2d(x, w, conv.bias, stride=stride, padding=padding)


def quan_linear(x: torch.Tensor, lin: nn.Linear, wbit: int,
                abit: int) -> torch.Tensor:
    w = dorefa_w(lin.weight, wbit) if wbit < 32 else lin.weight
    if abit < 32:
        x = dorefa_a(x, abit)
    return linear(x, w, lin.bias)


class ResBlock(nn.Module):
    """``conv1``..``conv3`` (two in a basic block) with their BNs, and
    ``down_conv``/``down_bn`` where the shape changes."""

    def __init__(self, kind: str, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.kind, self.stride = kind, stride
        out_ch = planes if kind == "basic" else 4 * planes
        if kind == "basic":
            shapes = [(inplanes, planes, 3), (planes, planes, 3)]
        else:
            shapes = [(inplanes, planes, 1), (planes, planes, 3),
                      (planes, out_ch, 1)]
        for i, (cin, cout, k) in enumerate(shapes, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, k, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(cout))
        if stride != 1 or inplanes != out_ch:
            self.down_conv = nn.Conv2d(inplanes, out_ch, 1, bias=False)
            self.down_bn = nn.BatchNorm2d(out_ch)
        else:
            self.down_conv = None


def res_plan(block: ResBlock) -> list:
    """The main path's ``(conv, bn, stride, padding)``: the stride on the
    3x3 conv."""
    s = block.stride
    if block.kind == "basic":
        return [(block.conv1, block.bn1, s, 1),
                (block.conv2, block.bn2, 1, 1)]
    return [(block.conv1, block.bn1, 1, 0), (block.conv2, block.bn2, s, 1),
            (block.conv3, block.bn3, 1, 0)]


def res_block(block: ResBlock, x: torch.Tensor, wbit: int, abit: int,
              stats: dict | None = None) -> torch.Tensor:
    """The basic (``resnet.py:143``) or bottleneck (``resnet.py:160``)
    block: the stride on the 3x3 conv, ReLU between, the residual added
    before the last ReLU."""
    s = block.stride
    plan = res_plan(block)
    out = x
    for i, (conv, bn, stride, pad) in enumerate(plan):
        out = batch_norm(bn, quan_conv(out, conv, wbit, abit, stride, pad),
                         stats)
        if i < len(plan) - 1:
            out = torch.relu(out)
    residual = x
    if block.down_conv is not None:
        residual = batch_norm(block.down_bn, quan_conv(
            x, block.down_conv, wbit, abit, stride=s), stats)
    return torch.relu(out + residual)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        k = 3 if cfg.cifar else 7
        self.conv1 = nn.Conv2d(3, 64, k, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.block_names = []
        inplanes = 64
        for li, (planes, nblocks) in enumerate(zip((64, 128, 256, 512),
                                                   cfg.stage_blocks)):
            for bi in range(nblocks):
                name = f"layer{li + 1}_{bi}"
                stride = 2 if li > 0 and bi == 0 else 1
                self.add_module(name, ResBlock(cfg.block, inplanes, planes,
                                               stride))
                self.block_names.append(name)
                inplanes = planes * cfg.expansion
        self.fc = nn.Linear(512 * cfg.expansion, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return resnet_apply(self, x, stats)


def resnet_apply(model: ResNet, x: torch.Tensor,
                 stats: dict | None = None) -> torch.Tensor:
    """NHWC images -> logits (``resnet.py:181``): the float stem, the
    blocks, the average pool and the 8-bit Linear."""
    cfg = model.cfg
    h = conv2d(nchw(x, model), model.conv1.weight, model.conv1.bias,
               stride=1 if cfg.cifar else 2, padding=1 if cfg.cifar else 3)
    h = torch.relu(batch_norm(model.bn1, h, stats))
    if not cfg.cifar:
        h = F.max_pool2d(h, 3, 2, 1)
    for name in model.block_names:
        h = res_block(getattr(model, name), h, cfg.wbit, cfg.abit, stats)
    h = avg_pool(h, h.shape[2], stride=1) if cfg.cifar \
        else avg_pool(h, 7, stride=1)
    return quan_linear(flatten(h), model.fc, 8, cfg.abit)


@torch.no_grad()
def init_resnet(model: ResNet, generator: torch.Generator) -> None:
    """The reference's init (``resnet.py:63``), drawn on the CPU: conv
    weights N(0, 2 / (k * k * out_channels)), BN weight 1 and bias 0, the
    Linear U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                       dtype=torch.float64)
                           * math.sqrt(2.0 / (kh * kw * m.out_channels)))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    bound = 1.0 / math.sqrt(model.fc.in_features)
    for p in (model.fc.weight, model.fc.bias):
        u = torch.rand(p.shape, generator=generator, dtype=torch.float64)
        p.copy_(u * (2 * bound) - bound)
