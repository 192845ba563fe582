"""LUT inference: run a compiled TTnet by table lookup instead of conv math
(counterpart of ``scale_imagenet_tpu/compile/lut_eval.py``).

Every Block_TT output filter is an exact function of its n window bits, so
inference reduces to::

    index = window bits read as an n-bit number      } one window-gather
    out   = table[filter, index]                     } kernel a block

bit-exact with the float block by construction.  The JAX package computes
the index with a small conv and gathers in a second kernel; here both run
in one launch of ``kernels/lut_gather.py`` (the CUDA kernels on the card,
their plain versions, which still take the index-conv route, on the CPU).
The routing mirrors the TPU path:

* config-identical heads (the flagship's heads 1+2 in every block) share
  one index and one launch on G-concatenated tables, concatenated once
  when the block's LUTs are built (``MultiHeadLUT.merged``);
* the last block's float (ReLU) fuse head runs as the float conv by default
  (``last_via_conv=True``), or as its float table (the table-exact variant);
* bits flow between blocks in bf16 on the card and in f32 on the CPU
  (``_bits``); bits, pooled quarter-means and the indices are exact in both;
* a block without a fuse head (``MultiHeadConfig.fuse`` off: the VGG-stem
  variant, ``lut_ttnet_vgg_stem_apply``) ends at the raw 4-head concat.

The TT_FHE family (``lut_tt_fhe_apply``, ``lut_tt_fhe_alexnet_apply``) runs
its float stem and classifier around the same table blocks.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.lut_gather import lut_window_bits, lut_window_float, \
    pack_bit_table, pack_float_table, window_out_size
from ..layers.pool import avg_pool, flatten
from ..models.block_tt import BlockTT, BlockTTConfig, _as_pair, block_tt
from ..models.classifier import classifier_scale
from ..models.multihead import MultiHeadBlock, MultiHeadConfig, \
    channel_interleave, reconcile_heads
from ..models.tt_fhe import TTFHE, TTFHEAlexnet, tt_fhe_alexnet_stem, \
    tt_fhe_head, tt_fhe_stem
from ..models.ttnet_imagenet import TTnetImageNet, TTnetVGGStem, _nchw, \
    stem, vgg_stem
from .truth_table import block_truth_table


@dataclasses.dataclass
class BlockLUT:
    cfg: BlockTTConfig
    # (G, F, W) int32 bit words, or (G, 2^n, F) float32 for a last block
    packed: torch.Tensor
    nonconstant: int               # filters whose table is not constant


def compile_block_tt_lut(block: BlockTT) -> BlockLUT:
    cfg = block.cfg
    table = block_truth_table(block)                    # (2^n, out)
    nonconstant = int((table != table[:1]).any(0).sum())
    pack = pack_float_table if cfg.last else pack_bit_table
    return BlockLUT(cfg=cfg, packed=pack(table, cfg.groupsici),
                    nonconstant=nonconstant)


def _nchw_out(out: torch.Tensor, cfg: BlockTTConfig,
              x: torch.Tensor) -> torch.Tensor:
    """``(E, C)`` gather output -> NCHW view (channels-last memory)."""
    h, w = window_out_size(x.shape[2], x.shape[3], cfg.k, cfg.stride,
                           cfg.padding)
    return out.view(x.shape[0], h, w, out.shape[1]).permute(0, 3, 1, 2)


def lut_block_tt_apply(lut: BlockLUT, x_bits: torch.Tensor) -> torch.Tensor:
    """``x_bits``: NCHW {0,1}; returns the block output (bits in the bit
    dtype, or float32 values for a last/ReLU block)."""
    c = lut.cfg
    gather = lut_window_float if c.last else lut_window_bits
    return _nchw_out(gather(x_bits, lut.packed, c.k, c.stride, c.padding),
                     c, x_bits)


def _merge_sig(b: BlockLUT):
    """Heads with equal signatures index the same windows and pack to
    same-shaped bit tables, so one launch serves them all."""
    if b.cfg.last:
        return None
    c = b.cfg
    return (_as_pair(c.k), c.stride, c.padding, c.groupsici, c.out_planes,
            c.in_planes, tuple(b.packed.shape))


def _merge_plan(heads: dict) -> list:
    """``[(head ids, words or None)]``: heads with one signature share a
    launch on their words concatenated along G (head-major); each merged
    head's ``packed`` becomes a view of them, so nothing is held twice."""
    groups: dict = {}
    for i in sorted(heads):
        groups.setdefault(_merge_sig(heads[i]), []).append(i)
    plan = []
    for sig, ids in groups.items():
        if sig is None or len(ids) == 1:
            plan += [((i,), None) for i in ids]
            continue
        words = torch.cat([heads[i].packed for i in ids])
        for i, part in zip(ids, words.split(heads[ids[0]].packed.shape[0])):
            heads[i].packed = part
        plan.append((tuple(ids), words))
    return plan


def _merged_heads_apply(heads: list[BlockLUT], words: torch.Tensor,
                        x_bits: torch.Tensor) -> list[torch.Tensor]:
    """One launch for k config-identical heads: one index a window, the
    heads' tables concatenated along G; the merged output channels are
    head-major, i.e. ``cat([out_1, .., out_k], channels)``."""
    c = heads[0].cfg
    out = lut_window_bits(x_bits, words, c.k, c.stride, c.padding,
                          heads=len(heads))
    return list(torch.split(_nchw_out(out, c, x_bits), c.out_planes, dim=1))


@dataclasses.dataclass
class MultiHeadLUT:
    cfg: MultiHeadConfig
    heads: dict                 # head index -> BlockLUT
    convf: BlockLUT | None      # None for a block without a fuse head
    # which heads share a launch, and their concatenated words: built once
    merged: list = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.merged = _merge_plan(self.heads)


def compile_multihead_lut(block: MultiHeadBlock) -> MultiHeadLUT:
    return MultiHeadLUT(
        cfg=block.cfg,
        heads={i: compile_block_tt_lut(block.head(i))
               for i in sorted(block.cfg.head_cfgs())},
        convf=compile_block_tt_lut(block.Block_convf)
        if block.cfg.fuse else None)


def lut_multihead_apply(lut: MultiHeadLUT, x_bits: torch.Tensor,
                        convf_float: BlockTT | None = None) -> torch.Tensor:
    """Mirror of ``multihead_block`` with every Block_TT as a LUT.

    ``convf_float``: the block's float fuse head.  When given and the fuse
    head is a last/ReLU block, it runs as the float conv it is (same
    function as its float table, conv speed)."""
    outs = {}
    for ids, words in lut.merged:
        if words is None:
            outs[ids[0]] = lut_block_tt_apply(lut.heads[ids[0]], x_bits)
        else:
            outs.update(zip(ids, _merged_heads_apply(
                [lut.heads[i] for i in ids], words, x_bits)))
    # heaviside(avgpool2(bits) - 0.5) == [mean of the 4 bits >= 0.5]
    cat = reconcile_heads(outs, lut.cfg, x_bits,
                          lambda pooled, _: (pooled >= 0.5).to(x_bits.dtype))
    if not lut.cfg.fuse:
        return cat
    cat = channel_interleave(cat, lut.cfg.cpt)
    if convf_float is not None and lut.convf.cfg.last:
        # the float block sees bits in its own dtype: its conv/BN/GELU
        # numerics are part of the bit-faithfulness contract
        return block_tt(convf_float, cat.to(convf_float.conv1.weight.dtype))
    return lut_block_tt_apply(lut.convf, cat)


@torch.no_grad()
def compile_ttnet_lut(model) -> list[MultiHeadLUT]:
    """Compile every multi-head block of a ttnet_imagenet model (the
    VGG-stem variant too), on the model's device."""
    return [compile_multihead_lut(b) for b in model.blocks]


@torch.no_grad()
def compile_tt_fhe_lut(model: TTFHE) -> list[MultiHeadLUT]:
    """A TT_FHE model's blocks as tables (``lut_eval.py:283``), with the
    JAX package's two refusals: a dead zone is stochastic, and the Bi-Real
    stem emits scaled signs, which no table can index."""
    spec = model.cfg.spec
    if model.cfg.stochastic:
        raise ValueError(
            f"{model.cfg.name}: noisy dead-zone Heaviside (T={spec['T']}, "
            f"T_block={spec['T_block']}) is stochastic at inference — a "
            "truth table cannot represent it; compiled-LUT serving needs "
            "a T=0 config")
    if spec.get("act") == "bireal":
        raise ValueError(
            f"{model.cfg.name}: the Bi-Real stem activation emits scaled "
            "sign values, not {0,1} bits — LUT blocks cannot index them")
    return compile_ttnet_lut(model)


def _bits(h: torch.Tensor, bits_dtype) -> torch.Tensor:
    """Cast fresh {0,1} bits to the serving bit dtype: bf16 on the card
    (halves the bytes of the pads, pools and gather outputs around the
    kernels), f32 on the CPU."""
    if bits_dtype is None:
        bits_dtype = torch.bfloat16 if h.is_cuda else torch.float32
    return h.to(bits_dtype)


@torch.no_grad()
def lut_ttnet_features(luts: list[MultiHeadLUT], model: TTnetImageNet,
                       x: torch.Tensor, last_via_conv: bool = True,
                       bits_dtype=None) -> torch.Tensor:
    """Everything before the classifier in LUT mode: float stem,
    table-lookup blocks, trailing pool + flatten.  ``x`` is NHWC."""
    h = _bits(stem(model, _nchw(x, model)), bits_dtype)
    for lut, block in zip(luts, model.blocks):
        h = lut_multihead_apply(
            lut, h, convf_float=block.Block_convf if last_via_conv else None)
    return flatten(avg_pool(h, 2)).to(model.stem_conv.weight.dtype)


@torch.no_grad()
def lut_ttnet_apply(luts: list[MultiHeadLUT], model: TTnetImageNet,
                    x: torch.Tensor, last_via_conv: bool = True,
                    bits_dtype=None) -> torch.Tensor:
    """Full LUT-mode forward: NHWC images -> logits.  ``last_via_conv=False``
    serves the last fuse head from its float table (the table-exact
    semantics).  Every float op (stem, last-block conv, classifier) runs in
    the model's dtype."""
    h = lut_ttnet_features(luts, model, x, last_via_conv=last_via_conv,
                           bits_dtype=bits_dtype)
    return classifier_scale(model.classifier, h)


@torch.no_grad()
def lut_ttnet_vgg_stem_apply(luts: list[MultiHeadLUT], model: TTnetVGGStem,
                             x: torch.Tensor,
                             bits_dtype=None) -> torch.Tensor:
    """LUT-mode forward of the VGG-stem variant (``lut_eval.py:348``): the
    float stem and classifier, its one block as tables (heads 1 and 2 in one
    merged launch, head 3 in another), ending at the raw concat.  NHWC
    images -> logits.  Compile with ``compile_ttnet_lut``."""
    h = _bits(vgg_stem(model, _nchw(x, model)), bits_dtype)
    h = lut_multihead_apply(luts[0], h)
    return classifier_scale(model.classifier,
                            flatten(h).to(model.stem_conv.weight.dtype))


@torch.no_grad()
def lut_tt_fhe_apply(luts: list[MultiHeadLUT], model: TTFHE,
                     x: torch.Tensor, bits_dtype=None) -> torch.Tensor:
    """LUT-mode forward of a TT_FHE model (``lut_eval.py:375``): the float
    stem and classifier head around the table blocks.  NHWC images ->
    logits.  Compile with ``compile_tt_fhe_lut``."""
    h = _bits(tt_fhe_stem(model, _nchw(x, model)), bits_dtype)
    for lut in luts:
        h = lut_multihead_apply(lut, h)
    return tt_fhe_head(model, h.to(model.stem_conv.weight.dtype))


@torch.no_grad()
def lut_tt_fhe_alexnet_apply(luts: list[MultiHeadLUT], model: TTFHEAlexnet,
                             x: torch.Tensor,
                             bits_dtype=None) -> torch.Tensor:
    """LUT-mode forward of ``TT_FHE_XSMALL_vAlexnet`` (``lut_eval.py:324``):
    the float VGG stem and linear head, its block (no fuse head) as
    tables.  Compile with ``compile_ttnet_lut``."""
    h = _bits(tt_fhe_alexnet_stem(model, _nchw(x, model)), bits_dtype)
    h = lut_multihead_apply(luts[0], h)
    return classifier_scale(model.classifier,
                            flatten(h).to(model.stem_conv.weight.dtype))
