"""Gate-circuit inference on the card: the minimized cube covers evaluated
bit-sliced, 32 window positions a 32-bit word (counterpart of
``scale_imagenet_tpu/compile/gate_device.py``)::

    plane_p[e]  = window bit p of position e          (bit-sliced input)
    cube_t      = AND over its fixed bits p of (plane_p == value_p)
    filter_f    = OR over its cubes                   (DNF; CNF inverts
                                                       the complement)

The JAX package evaluates this as XLA ops over a padded ``(G, F, T, W)``
mismatch tensor; here the covers go to the card compactly (each filter's
``(value, mask)`` cubes one after another, with offsets) and one launch of
the hand-written kernel ``kernels/gate_cubes.py`` evaluates a block.  The
plane packing and unpacking are plain torch ops.  Bit-identical to the host
evaluator and to the LUT forward (the covers are verified minterm-exact at
compile time).

Which circuits go to the card is decided on the bytes the port holds there
(``device_bytes``: the cubes, offsets and constant filters), not on JAX's
padded ``(G, F, T, n)`` footprint (``circuit_device_bytes``, kept for
comparison): ``build_device_gates`` refuses circuits over
``max_cube_bytes``, and the caller runs those on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.gate_cubes import gate_cubes
from ..layers.pool import constant_pad2d
from ..models.block_tt import BlockTT, BlockTTConfig, _as_pair
from ..models.multihead import MultiHeadConfig, channel_interleave, \
    reconcile_heads
from ..models.ttnet_imagenet import TTnetImageNet
from .gate_net import BlockGates, MultiHeadGates, _fuse, ttnet_gate_forward


@dataclasses.dataclass
class BlockGatesDev:
    """One block's covers on the card.

    ``cubes``: (T_total, 2) int32 (value, mask) of every filter's cover,
    filter ``g*F + f`` after filter ``g*F + f - 1``; ``offsets``: (G*F + 1,)
    int64 cube offsets; ``const_mask``/``const_val``: (G*F,) constant
    filters bypass the circuit; ``invert``: the CNF form (the cubes are the
    minimized complement; the result is inverted, De Morgan)."""
    cfg: BlockTTConfig
    cubes: torch.Tensor
    offsets: torch.Tensor
    const_mask: torch.Tensor
    const_val: torch.Tensor
    invert: bool


@dataclasses.dataclass
class MultiHeadGatesDev:
    cfg: MultiHeadConfig
    heads: dict                       # head index -> BlockGatesDev
    convf: BlockGatesDev | None


def circuit_device_bytes(bg: BlockGates, form: str = "dnf") -> int:
    """Padded cube-tensor footprint of one block on the device, as the JAX
    package counts it (its budget rule; the port stores far less, see
    ``device_bytes``)."""
    covers = bg.covers if form == "dnf" else bg.cnf_covers
    cfg = bg.cfg
    g = cfg.groupsici
    f = cfg.out_planes // g
    t = max((len(c) for c in covers), default=0)
    n = cfg.n_bits
    return 2 * g * f * max(t, 1) * n * 4


def device_bytes(bg: BlockGates, form: str = "dnf") -> int:
    """Bytes one block's ``BlockGatesDev`` holds on the card: the ``(T,
    2)`` int32 cubes (8 bytes a cube), the ``(G*F + 1,)`` int64 offsets and
    the constant filters' mask (bool) and value (f32)."""
    covers = bg.covers if form == "dnf" else bg.cnf_covers
    filters = len(covers)
    return sum(len(c) for c in covers) * 8 + (filters + 1) * 8 + filters * 5


def build_device_block(bg: BlockGates, form: str = "dnf",
                       device=None) -> BlockGatesDev:
    if form not in ("dnf", "cnf"):
        raise ValueError(f"form must be 'dnf' or 'cnf', got {form!r}")
    covers = bg.covers if form == "dnf" else bg.cnf_covers
    offsets = np.zeros(len(covers) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(cv) for cv in covers])
    flat = np.concatenate([np.asarray(cv, np.uint32).reshape(-1, 2)
                           for cv in covers] or [np.zeros((0, 2), np.uint32)])
    const_mask = np.asarray([c is not None for c in bg.constants])
    const_val = np.asarray([0.0 if c is None else c for c in bg.constants],
                           dtype=np.float32)
    dev = torch.device("cpu") if device is None else torch.device(device)
    return BlockGatesDev(
        cfg=bg.cfg,
        cubes=torch.from_numpy(flat.view(np.int32).copy()).to(dev),
        offsets=torch.from_numpy(offsets).to(dev),
        const_mask=torch.from_numpy(const_mask).to(dev),
        const_val=torch.from_numpy(const_val).to(dev),
        invert=form == "cnf")


def build_device_gates(gnets: list[MultiHeadGates], form: str = "dnf", *,
                       max_cube_bytes: int = 1 << 30,
                       device=None) -> list[MultiHeadGatesDev]:
    """Device twins of compiled gate nets on ``device``; raises when the
    covers would take more than ``max_cube_bytes`` on the card, counted as
    the port holds them (``device_bytes``; the JAX package counts its
    padded tensors instead), and the caller falls back to the host
    evaluator."""
    total = sum(device_bytes(h, form)
                for mg in gnets for h in list(mg.heads.values())
                + ([mg.convf] if mg.convf else []))
    if total > max_cube_bytes:
        raise ValueError(
            f"device gate circuit needs {total:,} bytes of covers on the "
            f"card (cubes, offsets and constants as the port holds them, "
            f"not JAX's padded cube tensors) > the {max_cube_bytes:,}-byte "
            "budget — use the host evaluator for circuits this large")
    return [
        MultiHeadGatesDev(
            cfg=mg.cfg,
            heads={i: build_device_block(h, form, device)
                   for i, h in mg.heads.items()},
            convf=build_device_block(mg.convf, form, device)
            if mg.convf else None)
        for mg in gnets
    ]


def _pack_planes_device(x_bits: torch.Tensor, cfg: BlockTTConfig):
    """NCHW {0,1} -> bit-sliced planes ``(G, n, W)`` int32 (position 32*w
    + i is bit i of word w, positions in (batch, row, column) order), in
    plain torch ops.  Bit order as ``gate_net._pack_planes``: pattern bit
    p = n-1-j for window bit j = c*kh*kw + a*kw + b."""
    kh, kw = _as_pair(cfg.k)
    g = cfg.groupsici
    ci = cfg.in_planes // g
    s = cfg.stride
    n = cfg.n_bits
    if cfg.padding:
        x_bits = constant_pad2d(x_bits, cfg.padding)
    b, _, hp, wp = x_bits.shape
    ho = (hp - kh) // s + 1
    wo = (wp - kw) // s + 1
    # channels g*ci + c of every group: a strided channel slice
    sls = [x_bits[:, c::ci, a:a + s * ho:s, bb:bb + s * wo:s]
           for c in range(ci) for a in range(kh) for bb in range(kw)]
    bits = torch.stack(sls[::-1]).to(torch.int32)     # (n, B, G, Ho, Wo)
    e = b * ho * wo
    w_words = -(-e // 32)
    bits = bits.permute(2, 0, 1, 3, 4).reshape(g, n, e)
    if w_words * 32 != e:
        bits = torch.nn.functional.pad(bits, (0, w_words * 32 - e))
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    words = (bits.view(g, n, w_words, 32) << shifts).sum(
        -1, dtype=torch.int32)
    return words, (b, ho, wo), e


def gate_block_apply_device(dev: BlockGatesDev,
                            x_bits: torch.Tensor) -> torch.Tensor:
    """One compiled block as its boolean circuit on ``x_bits``' device.
    ``x_bits``: NCHW {0,1} (any float dtype); returns NCHW bits in the
    same dtype."""
    cfg = dev.cfg
    dtype = x_bits.dtype
    planes, (b, ho, wo), e = _pack_planes_device(x_bits, cfg)
    g = cfg.groupsici
    f = cfg.out_planes // g
    out_words = gate_cubes(planes, dev.cubes, dev.offsets, f, dev.invert)
    shifts = torch.arange(32, device=planes.device, dtype=torch.int32)
    bits = (out_words.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(g * f, -1)[:, :e].to(dtype)  # (G*F, E)
    # constant filters bypass the circuit
    bits = torch.where(dev.const_mask[:, None],
                       dev.const_val[:, None].to(dtype), bits)
    return bits.view(g * f, b, ho, wo).permute(1, 0, 2, 3)


def gate_multihead_apply_device(mdev: MultiHeadGatesDev,
                                x_bits: torch.Tensor, *,
                                convf_float: BlockTT | None = None) \
        -> torch.Tensor:
    """Device mirror of ``gate_multihead_apply``."""
    cfg = mdev.cfg
    outs = {i: gate_block_apply_device(mdev.heads[i], x_bits)
            for i in sorted(mdev.heads)}
    cat = reconcile_heads(outs, cfg, x_bits,
                          lambda pooled: (pooled >= 0.5).to(x_bits.dtype))
    cat = channel_interleave(cat, cfg.cpt)
    return _fuse(cat, mdev.convf, convf_float, gate_block_apply_device)


@torch.no_grad()
def gate_ttnet_apply_device(gdevs: list[MultiHeadGatesDev],
                            model: TTnetImageNet,
                            x: torch.Tensor) -> torch.Tensor:
    """Full device gate-circuit forward of a ttnet_imagenet model: NHWC
    images -> logits (mirror of ``gate_ttnet_apply``)."""
    return ttnet_gate_forward(
        model, x, lambda i, block, h: gate_multihead_apply_device(
            gdevs[i], h, convf_float=block.Block_convf))
