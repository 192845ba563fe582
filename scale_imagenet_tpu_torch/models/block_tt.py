"""The TTnet cell (counterpart of ``scale_imagenet_tpu/models/block_tt.py``).

Forward (eval, or training with a ``stats`` sink), matching the reference
Block_TT::

    constant-pad -> grouped conv (in -> t*in, kernel k, ``groupsici`` groups)
    -> BN -> GELU (exact erf) -> grouped 1x1 conv (t*in -> out) -> BN
    -> Heaviside   (ReLU instead when ``last``)

Every output filter sees ``n = k_h * k_w * (in / groupsici)`` input bits, so
it compiles to a truth table (``compile/``).  With
``config.performance.fused_pointwise_blocks`` on, a k=1 stride-1 unpadded
block runs as the fused pointwise kernel instead (``kernels/fused_block.py``;
the gate of ``scale_imagenet_tpu/models/block_tt.py:94-100``; the GELU
there is the polynomial erf).  The JAX gate also asks for a TPU backend; here the
kernel's wrapper takes the CUDA kernel for a CUDA tensor and its plain
version for a CPU one.  As there, the gate never fires in training, which
keeps the exact erf and the batch statistics, and it takes only a float
first conv (``quant == "float"``) and a deterministic output (``T == 0``):
a block with a dead zone draws its coin flips from a ``NoiseKey``
(``ops/binarize.py``) in eval too, which the kernel does not.  The
BinConv2d first conv (``quant == "bin"``) and the input fault mask come
with the families that use them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import performance
from ..kernels.fused_block import block_tt_pointwise_params, \
    fused_pointwise_nchw
from ..layers.conv import conv2d
from ..layers.norm import batch_norm
from ..layers.pool import constant_pad2d
from ..ops.binarize import Binarize01Act, NoiseKey, binarize01_act
from ..ops.gelu import gelu


def _as_pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


@dataclasses.dataclass(frozen=True)
class BlockTTConfig:
    in_planes: int
    out_planes: int
    k: int | tuple = 3
    t: int = 8                 # channel amplification of the first conv
    padding: int = 1
    stride: int = 1
    groupsici: int = 1
    quant: str = "float"       # "float" | "bin" (BinConv2d first conv)
    T: float = 0.0             # Heaviside dead-zone width
    last: bool = False         # ReLU instead of Heaviside on the output

    @property
    def n_bits(self) -> int:
        """Input bits per output filter."""
        kh, kw = _as_pair(self.k)
        return kh * kw * (self.in_planes // self.groupsici)


class BlockTT(nn.Module):
    """Parameters under the reference names ``conv1``/``bn1``/``conv2``/
    ``bn2``/``act``."""

    def __init__(self, cfg: BlockTTConfig):
        super().__init__()
        if cfg.quant != "float":
            raise NotImplementedError(
                f"Block_TT with quant={cfg.quant!r} (the BinConv2d first "
                "conv) comes with the families that use it; see ROADMAP.md "
                "queue A")
        self.cfg = cfg
        mid = cfg.t * cfg.in_planes
        self.conv1 = nn.Conv2d(cfg.in_planes, mid, _as_pair(cfg.k),
                               stride=cfg.stride, groups=cfg.groupsici,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, cfg.out_planes, 1, groups=cfg.groupsici,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(cfg.out_planes)
        self.act = Binarize01Act()
        self._folded = None            # (key, params): pointwise_params

    def forward(self, x: torch.Tensor, pre_padded: bool = False,
                stats: dict | None = None, noise: NoiseKey | None = None):
        return block_tt(self, x, pre_padded, stats, noise)

    def pointwise_params(self) -> tuple:
        """``block_tt_pointwise_params`` folded once and kept: it is folded
        again only when a weight, conv bias or BN statistic is added or
        replaced (``.to``, ``convert/bn_fold.py``) or written in place
        (``load_state_dict``), which the tensors' presence, storage and
        version counters show."""
        tensors = (self.conv1.weight, self.conv1.bias, self.conv2.weight,
                   self.conv2.bias, self.bn1.weight, self.bn1.bias,
                   self.bn1.running_mean, self.bn1.running_var,
                   self.bn2.weight, self.bn2.bias, self.bn2.running_mean,
                   self.bn2.running_var)
        # an inference tensor keeps no version counter
        key = tuple(None if t is None else
                    (t.data_ptr(), 0 if t.is_inference() else t._version)
                    for t in tensors)
        if self._folded is None or self._folded[0] != key:
            self._folded = (key, block_tt_pointwise_params(self))
        return self._folded[1]


def takes_fused_kernel(cfg: BlockTTConfig, training: bool) -> bool:
    """The gate of ``scale_imagenet_tpu/models/block_tt.py:94-97``, less its
    TPU test: eval, the switch on, a k=1 stride-1 unpadded block with a
    float first conv and a deterministic output."""
    return (not training and performance.fused_pointwise_blocks
            and _as_pair(cfg.k) == (1, 1) and cfg.stride == 1
            and cfg.padding == 0 and cfg.quant == "float" and cfg.T == 0.0)


def block_tt(block: BlockTT, x: torch.Tensor, pre_padded: bool = False,
             stats: dict | None = None,
             noise: NoiseKey | None = None) -> torch.Tensor:
    """Forward on NCHW ``x``: eval, or training when ``stats`` is given (a
    dict that receives each BN's new running statistics,
    ``layers/norm.py``).  ``pre_padded`` skips the pad for callers that
    already padded (the truth-table enumerator).  ``noise`` is the key of
    the output's coin flips, which a block with ``T != 0`` needs."""
    cfg = block.cfg
    if takes_fused_kernel(cfg, stats is not None):
        return fused_pointwise_nchw(x, block.pointwise_params(),
                                    "relu" if cfg.last else "heaviside")
    if cfg.padding != 0 and not pre_padded:
        x = constant_pad2d(x, cfg.padding)
    # a conv bias exists after BN folding (``convert/bn_fold.py``)
    out = conv2d(x, block.conv1.weight, block.conv1.bias, stride=cfg.stride,
                 groups=cfg.groupsici)
    out = gelu(batch_norm(block.bn1, out, stats))
    out = conv2d(out, block.conv2.weight, block.conv2.bias,
                 groups=cfg.groupsici)
    out = batch_norm(block.bn2, out, stats)
    # the dead zone applies in eval too (``block_tt.py:120-124``)
    if cfg.last:
        return torch.relu(out)
    return binarize01_act(out, cfg.T, noise)


def block_tt_out_size(cfg: BlockTTConfig, h: int, w: int) -> tuple[int, int]:
    kh, kw = _as_pair(cfg.k)
    return ((h + 2 * cfg.padding - kh) // cfg.stride + 1,
            (w + 2 * cfg.padding - kw) // cfg.stride + 1)
