"""Gate-level inference on the host: a compiled TTnet run as the boolean
circuit its gate counts meter (counterpart of
``scale_imagenet_tpu/compile/gate_net.py``).

Every Heaviside filter's truth table is minimized to a cube cover
(espresso, verified minterm-exact), and a forward evaluates the covers as
word-parallel AND/OR/NOT over 64 positions a machine word
(``native/ttlogic.cpp::ttlogic_eval_covers``).  Gate outputs are therefore
bit-identical to the LUT forward and to the float block.  The CNF form
evaluates NOT(minimized complement cover), De Morgan, the clause set
``logic._terms_to_cnf`` prints.

The TT_FHE family runs its float stem and head around the same circuit
blocks (``gate_tt_fhe_apply``, ``gate_tt_fhe_alexnet_apply``).

Float parts (stem, classifier, the last block's float/ReLU fuse head) run
as the float ops they are, as in the LUT forward: the fuse head through the
port's ``block_tt`` (the fused pointwise kernel when
``config.performance.fused_pointwise_blocks`` is on).

The per-filter espresso calls of a block run on a thread pool (the engine
releases the interpreter lock), collected in filter order, so covers and
gate counts equal a sequential run's.  Activations are NCHW, as in the rest
of the port; ``gate_ttnet_apply`` takes NHWC images like every forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..layers.pool import avg_pool, flatten
from ..models.block_tt import BlockTT, BlockTTConfig, _as_pair, block_tt
from ..models.classifier import classifier_scale
from ..models.multihead import MultiHeadBlock, MultiHeadConfig, \
    channel_interleave, reconcile_heads
from ..models.tt_fhe import TTFHE, TTFHEAlexnet, tt_fhe_alexnet_stem, \
    tt_fhe_head, tt_fhe_stem
from ..models.ttnet_imagenet import TTnetImageNet, TTnetVGGStem, _nchw, \
    stem, vgg_stem
from ..native import eval_covers, pack_table_bits
from .logic import map_in_order, minimize_packed
from .lut_eval import _bits
from .truth_table import block_truth_table

_EMPTY = np.zeros((0, 2), dtype=np.uint32)


@dataclasses.dataclass
class BlockGates:
    """One Block_TT compiled to per-filter cube covers.

    ``covers[f]``: (T, 2) uint32 (value, mask) DNF cubes of filter f;
    ``cnf_covers[f]``: minimized cubes of the complement (one CNF clause
    each, De Morgan); ``constants[f]``: 0.0/1.0 for constant filters (both
    cover lists empty there), else None; ``gates``: DNF gate count over the
    non-constant filters (the meter of ``logic.count_gates``)."""
    cfg: BlockTTConfig
    covers: list
    cnf_covers: list
    constants: list
    gates: int


def compile_block_gates(block: BlockTT,
                        threads: int | None = None) -> BlockGates:
    """Truth table -> verified minimal covers for every filter, the
    minimizations on ``threads`` threads (default: the usable cores).
    Only Heaviside ({0,1}-valued) blocks compile to gates; a last/ReLU
    block is float-valued and is served as the float conv it is."""
    cfg = block.cfg
    if cfg.last:
        raise ValueError("a last/ReLU block is float-valued — no gate "
                         "form exists; serve it as the float conv "
                         "(see gate_multihead_apply)")
    table = block_truth_table(block).cpu().numpy()      # (2^n, out)
    n = cfg.n_bits
    constants, jobs = [], []
    for f in range(table.shape[1]):
        col = table[:, f]
        vals = set(np.unique(col).tolist())
        if not vals <= {0.0, 1.0}:
            raise ValueError(f"filter {f} is not binary-valued "
                             f"(values {sorted(vals)[:4]}...) — only "
                             "Heaviside blocks compile to gates")
        if len(vals) == 1:
            constants.append(float(col[0]))
            continue
        constants.append(None)
        jobs.append(pack_table_bits((col != 0).astype(np.uint8)))
    minimized = iter(map_in_order(lambda bits: minimize_packed(bits, n),
                                  jobs, threads))
    covers, cnf_covers, gates = [], [], 0
    for const in constants:
        if const is not None:
            covers.append(_EMPTY)
            cnf_covers.append(_EMPTY)
            continue
        res = next(minimized)
        covers.append(np.asarray(res["terms"],
                                 dtype=np.uint32).reshape(-1, 2))
        cnf_covers.append(
            np.asarray(res["cnf_terms"], dtype=np.uint32).reshape(-1, 2))
        gates += res["gates"]
    return BlockGates(cfg=cfg, covers=covers, cnf_covers=cnf_covers,
                      constants=constants, gates=gates)


def _pack_planes(x: np.ndarray, cfg: BlockTTConfig, group: int):
    """Window bit planes of one group of NCHW uint8 bits ``x`` (already
    padded), bit-sliced: plane p = pattern bit p (p = n-1-j for window bit
    j = c*kh*kw + a*kw + b, the bit order of ``enumerate_patterns``),
    positions in (batch, row, column) order, 64 a word."""
    kh, kw = _as_pair(cfg.k)
    ci = cfg.in_planes // cfg.groupsici
    n = cfg.n_bits
    s = cfg.stride
    bsz, _, hp, wp = x.shape
    ho = (hp - kh) // s + 1
    wo = (wp - kw) // s + 1
    positions = bsz * ho * wo
    words = (positions + 63) // 64
    planes = np.zeros((n, words), dtype=np.uint64)
    for c in range(ci):
        for a in range(kh):
            for b in range(kw):
                j = c * kh * kw + a * kw + b
                sl = x[:, group * ci + c, a:a + s * ho:s, b:b + s * wo:s]
                pb = np.packbits(sl.reshape(-1), bitorder="little")
                pb = np.pad(pb, (0, words * 8 - len(pb)))
                planes[n - 1 - j] = pb.view("<u8")
    return planes, (bsz, ho, wo), positions


def gate_block_apply(bg: BlockGates, x_bits: torch.Tensor,
                     form: str = "dnf") -> torch.Tensor:
    """Run one compiled block as its gate circuit on the host.  ``x_bits``:
    NCHW {0,1} (any float dtype, any device); returns NCHW bits in the same
    dtype on the same device.  ``form``: "dnf" evaluates each filter's
    cover; "cnf" evaluates the minimized complement and inverts."""
    if form not in ("dnf", "cnf"):
        raise ValueError(f"form must be 'dnf' or 'cnf', got {form!r}")
    cfg = bg.cfg
    x = (x_bits.detach() != 0).to(torch.uint8).cpu().numpy()
    if cfg.padding != 0:
        p = cfg.padding
        x = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)))
    n = cfg.n_bits
    opg = cfg.out_planes // cfg.groupsici
    out = None
    for g in range(cfg.groupsici):
        planes, (bsz, ho, wo), positions = _pack_planes(x, cfg, g)
        if out is None:
            out = np.zeros((bsz, cfg.out_planes, ho, wo), dtype=np.uint8)
        filt = range(g * opg, (g + 1) * opg)
        live = [f for f in filt if bg.constants[f] is None]
        if live:
            covs = [(bg.covers if form == "dnf" else bg.cnf_covers)[f]
                    for f in live]
            res = eval_covers(planes, covs, n)
            if form == "cnf":
                res = ~res          # NOT(complement); tail bits dropped
            for row, f in zip(res, live):
                out[:, f] = np.unpackbits(
                    row.view(np.uint8), bitorder="little",
                    count=positions).reshape(bsz, ho, wo)
        for f in filt:
            if bg.constants[f] is not None:
                out[:, f] = np.uint8(bg.constants[f])
    return torch.from_numpy(out).to(device=x_bits.device,
                                    dtype=x_bits.dtype)


@dataclasses.dataclass
class MultiHeadGates:
    cfg: MultiHeadConfig
    heads: dict                     # head index -> BlockGates
    convf: BlockGates | None        # None when the fuse head is float or
    gates: int                      # absent (``cfg.fuse`` off)


def compile_multihead_gates(block: MultiHeadBlock,
                            threads: int | None = None) -> MultiHeadGates:
    cfg = block.cfg
    heads = {i: compile_block_gates(block.head(i), threads)
             for i in sorted(cfg.head_cfgs())}
    convf = None
    if cfg.fuse and not cfg.convf_cfg().last:
        convf = compile_block_gates(block.Block_convf, threads)
    total = sum(h.gates for h in heads.values()) \
        + (convf.gates if convf else 0)
    return MultiHeadGates(cfg=cfg, heads=heads, convf=convf, gates=total)


def _fuse(cat: torch.Tensor, convf, convf_float: BlockTT | None, apply):
    """The fuse head: its circuit, or the float conv of a float head."""
    if convf is None:
        if convf_float is None:
            raise ValueError("float fuse head needs convf_float=<the "
                             "block's float fuse head>")
        return block_tt(convf_float, cat.to(convf_float.conv1.weight.dtype))
    return apply(convf, cat)


def gate_multihead_apply(mg: MultiHeadGates, x_bits: torch.Tensor, *,
                         form: str = "dnf",
                         convf_float: BlockTT | None = None) -> torch.Tensor:
    """Gate-circuit mirror of ``lut_multihead_apply``: per-head circuits,
    the shared head reconciliation (pool-rebinarize, fixup pads, crop,
    concat), channel interleave, fuse head.  A float/last fuse head runs as
    the float block ``convf_float``."""
    cfg = mg.cfg
    outs = {i: gate_block_apply(mg.heads[i], x_bits, form=form)
            for i in sorted(mg.heads)}
    # heaviside(avgpool2(bits) - 0.5) == [mean of the 4 bits >= 0.5]
    cat = reconcile_heads(outs, cfg, x_bits,
                          lambda pooled, _: (pooled >= 0.5).to(x_bits.dtype))
    if not cfg.fuse:
        return cat
    cat = channel_interleave(cat, cfg.cpt)
    return _fuse(cat, mg.convf, convf_float,
                 lambda bg, c: gate_block_apply(bg, c, form=form))


@torch.no_grad()
def compile_ttnet_gates(model,
                        threads: int | None = None) -> list[MultiHeadGates]:
    """Compile every multi-head block of a ttnet_imagenet model (the
    VGG-stem variant too) to gate circuits (the float stem and classifier
    stay float)."""
    return [compile_multihead_gates(b, threads) for b in model.blocks]


def total_gates(gnets: list) -> int:
    return sum(g.gates for g in gnets)


def ttnet_gate_forward(model: TTnetImageNet, x: torch.Tensor,
                       block_apply) -> torch.Tensor:
    """Float stem, ``block_apply(i, block, h)`` for each multi-head block,
    trailing pool, flatten and float classifier.  Bits flow as the LUT
    forward's do (bf16 on the card, f32 on the CPU)."""
    from .lut_eval import _bits

    h = _bits(stem(model, _nchw(x, model)), None)
    for i, block in enumerate(model.blocks):
        h = block_apply(i, block, h)
    h = flatten(avg_pool(h, 2)).to(model.stem_conv.weight.dtype)
    return classifier_scale(model.classifier, h)


@torch.no_grad()
def gate_ttnet_apply(gnets: list[MultiHeadGates], model: TTnetImageNet,
                     x: torch.Tensor, *, form: str = "dnf") -> torch.Tensor:
    """Full host gate-circuit forward of a ttnet_imagenet model: NHWC
    images -> logits (mirror of ``lut_ttnet_apply``)."""
    return ttnet_gate_forward(
        model, x, lambda i, block, h: gate_multihead_apply(
            gnets[i], h, form=form, convf_float=block.Block_convf))


def vgg_stem_gate_forward(model: TTnetVGGStem, x: torch.Tensor,
                          block_apply) -> torch.Tensor:
    """The VGG-stem variant's float stem, ``block_apply(block, h)`` on its
    one block, flatten and the float classifier."""
    h = block_apply(model.blocks[0],
                    _bits(vgg_stem(model, _nchw(x, model)), None))
    return classifier_scale(model.classifier,
                            flatten(h).to(model.stem_conv.weight.dtype))


@torch.no_grad()
def gate_ttnet_vgg_stem_apply(gnets: list[MultiHeadGates],
                              model: TTnetVGGStem, x: torch.Tensor, *,
                              form: str = "dnf") -> torch.Tensor:
    """Host gate-circuit forward of the VGG-stem variant (``gate_net.py:
    287``): NHWC images -> logits; the block has no fuse head."""
    return vgg_stem_gate_forward(
        model, x, lambda block, h: gate_multihead_apply(gnets[0], h,
                                                        form=form))


@torch.no_grad()
def compile_tt_fhe_gates(model: TTFHE,
                         threads: int | None = None) -> list[MultiHeadGates]:
    """A TT_FHE model's blocks as gate circuits (``gate_net.py:227``), with
    the refusals of ``compile_tt_fhe_lut``."""
    spec = model.cfg.spec
    if model.cfg.stochastic:
        raise ValueError(
            f"{model.cfg.name}: noisy dead-zone Heaviside (T={spec['T']}, "
            f"T_block={spec['T_block']}) is stochastic at inference — a "
            "gate circuit cannot represent it; needs a T=0 config")
    if spec.get("act") == "bireal":
        raise ValueError(
            f"{model.cfg.name}: the Bi-Real stem activation emits scaled "
            "sign values, not {0,1} bits — gate blocks cannot consume them")
    return compile_ttnet_gates(model, threads)


def tt_fhe_gate_forward(model: TTFHE, x: torch.Tensor,
                        block_apply) -> torch.Tensor:
    """A TT_FHE model's float stem, ``block_apply(i, h)`` for each block,
    and its float head.  Bits flow as the LUT forward's do."""
    h = _bits(tt_fhe_stem(model, _nchw(x, model)), None)
    for i in range(model.n_blocks):
        h = block_apply(i, h)
    return tt_fhe_head(model, h.to(model.stem_conv.weight.dtype))


def tt_fhe_alexnet_gate_forward(model: TTFHEAlexnet, x: torch.Tensor,
                                block_apply) -> torch.Tensor:
    """``TT_FHE_XSMALL_vAlexnet``'s float stem, ``block_apply(0, h)`` on
    its block, flatten and the float classifier."""
    h = block_apply(0, _bits(tt_fhe_alexnet_stem(model, _nchw(x, model)),
                             None))
    return classifier_scale(model.classifier,
                            flatten(h).to(model.stem_conv.weight.dtype))


@torch.no_grad()
def gate_tt_fhe_apply(gnets: list[MultiHeadGates], model: TTFHE,
                      x: torch.Tensor, *, form: str = "dnf") -> torch.Tensor:
    """Host gate-circuit forward of a TT_FHE model (``gate_net.py:333``):
    NHWC images -> logits."""
    return tt_fhe_gate_forward(model, x, lambda i, h: gate_multihead_apply(
        gnets[i], h, form=form))


@torch.no_grad()
def gate_tt_fhe_alexnet_apply(gnets: list[MultiHeadGates],
                              model: TTFHEAlexnet, x: torch.Tensor, *,
                              form: str = "dnf") -> torch.Tensor:
    """Host gate-circuit forward of ``TT_FHE_XSMALL_vAlexnet``
    (``gate_net.py:311``); compile with ``compile_ttnet_gates``."""
    return tt_fhe_alexnet_gate_forward(
        model, x, lambda i, h: gate_multihead_apply(gnets[i], h, form=form))
