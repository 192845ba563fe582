"""Spatial partitioning over ranks, ``--sp`` (counterpart of
``scale_imagenet_tpu/parallel/sharding.py::spatial_sharding`` and of
``train/steps.py::make_eval_step(spatial=True)``).

JAX shards each image batch over ``data`` and the image height over
``model`` (``P("data", "model", None, None)``) and lets GSPMD insert the
halo exchange of every conv and pool.  Here one process drives one card:
the ranks of a model group (``parallel/mesh.py``) hold the rows of their
data index's images, each rank every channel and every column, and the
exchanges are explicit.

**The partition.**  At every layer, of global height ``h``, model rank
``m`` of ``n`` owns the rows ``[m c, min(h, (m + 1) c))``, ``c = ceil(h /
n)`` (GSPMD's ceiling split, ``row_bounds``).  Only the input height
divides by ``n`` (JAX's check); the inner heights need not (the flagship
at 224²: 56, 29, 15, 8, then 4 entering the flatten), so the slices are
uneven, a rank may own fewer rows than a halo, and a slice may be empty.
A rank holds ``max(1, owned)`` rows: an empty slice keeps one phantom
row that no exchange reads, so every rank runs every op on the same
graph and takes part in every collective in the same order, the
backward's too.

**One exchange per row-mixing op.**  Each op that mixes rows computes
only the rank's own output rows, with zero padding only at the global
top and bottom.  Output row ``o`` reads the input rows ``[o s + a, o s +
a + k)``:

* the s2d stem (``kernels/stem.py``): ``s = 4, a = -6, k = 16``;
* a ``block_tt`` head that pads, strides or is taller than one row
  (heads 1 and 2): ``s`` its stride, ``a = -padding``, ``k`` its kernel
  height;
* the stride-2 pools (head 4, the re-pool of head 3, the pool before the
  flatten): ``s = 2, a = 0, k = 2`` (an odd height floors);
* a fix-up pad (``FIXUP_RULES``): ``s = 1, a = -top, k = 1`` over the
  padded height, and the crop to the smallest head ``s = 1, a = 0, k =
  1`` over the cropped one.

``fetch_rows`` gives the rank those input rows (zeros outside ``[0,
h)``), and the unmodified op runs on them, unpadded in height.  The rest
is row-local and runs on the rank's rows as it is: BN in eval, GELU, the
Heaviside, the k = 1 heads (the fused pointwise kernel among them), the
channel interleave.  One exchange per op keeps each op's index
arithmetic to the line above and the row-local code untouched; one
exchange per block would have to follow a block's receptive field
through the fix-up pads' shifts and keep each slab's own zero pads in
rows that are cropped away.  Heads 1 and 2 of a block read the same rows
where their kernels agree (the flagship), and share one exchange.

**The exchange.**  Every rank knows the rows every rank needs (they
follow from the op), so each writes the rows it owns of every other
rank's halo into one buffer, and one ``all_reduce`` over the model group
hands every rank its halo (a sum in which each row has its one owner as
its only term: exact).  The backward sends each halo row's gradient back
through the same buffer to its owner, which adds it to its own
(``--attack`` differentiates through it).  ``all_reduce`` and
``broadcast`` are the collectives gloo takes with CUDA tensors, so the
one route serves gloo, where ranks share a card, and NCCL; a bf16 buffer
travels as f32 (exact both ways).

**The classifier.**  ``flatten`` is channel-major, so a rank's rows are
not contiguous in the features: ``gather_rows`` gives every model rank
the whole pooled features (16,384 an image on the flagship), and the
classifier runs whole on each, the same function on the same features as
the one-process forward.  Its backward keeps the rank's own rows of the
gradient: every model rank holds the same loss, and a sum over the group
would count it ``n`` times.

The port's row-sharded forward covers the ttnet_imagenet family
(``TTnetImageNet``: every variant and stem); the other families raise
``SP_FAMILY``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..kernels.stem import s2d_conv, stem_pad
from ..layers.conv import conv2d
from ..layers.norm import batch_norm
from ..layers.pool import avg_pool, flatten
from ..models.block_tt import _as_pair, block_tt
from ..models.classifier import classifier_scale
from ..models.multihead import FIXUP_RULES, channel_interleave
from ..models.ttnet_imagenet import TTnetImageNet, TTnetImageNetConfig, \
    _nchw
from ..ops.binarize import binarize01_act
from .data_parallel import _dist

# the port's rule: JAX's GSPMD partitions any model
SP_FAMILY = ("--sp: the port's row-sharded forward (parallel/sp.py) covers "
             "the ttnet_imagenet family so far, not {}; the JAX package's "
             "GSPMD partitions any model (see ROADMAP.md)")
# ``scale_imagenet_tpu/train/steps.py:178``, ``main.py:1044-1045``
SP_MESH = "spatial partitioning needs a mesh"
SP_HEIGHT = "--sp: image height {} not divisible by --mesh_model {}"


def row_bounds(h: int, n: int, m: int) -> tuple:
    """The rows ``[lo, hi)`` that model rank ``m`` of ``n`` owns at height
    ``h`` (GSPMD's ceiling split; empty past the end)."""
    c = -(-h // n)
    return min(h, m * c), min(h, (m + 1) * c)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A rank's place on the model axis: ``n`` ranks, this one ``index``;
    ``group`` the model axis's process group (None: every rank), or any
    object whose ``all_reduce(t)`` sums ``t`` over the ranks in place (an
    in-process stand-in for one)."""
    n: int
    index: int
    group: object = None

    def bounds(self, h: int) -> tuple:
        return row_bounds(h, self.n, self.index)


def row_shard(mesh) -> RowShard:
    """A mesh rank's ``RowShard`` (``parallel/mesh.py``)."""
    return RowShard(mesh["model"], mesh.model_index, mesh.model_group)


def local_rows(images: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The rank's rows of an NHWC batch, whose height must divide by the
    model axis (``scale_imagenet_tpu/main.py:1042-1045``)."""
    h = images.shape[1]
    if h % shard.n:
        raise ValueError(SP_HEIGHT.format(h, shard.n))
    lo, hi = shard.bounds(h)
    return images[:, lo:hi]


def _sum_(t: torch.Tensor, shard: RowShard) -> None:
    stand_in = getattr(shard.group, "all_reduce", None)
    if stand_in is not None:
        stand_in(t)
        return
    dist = _dist(shard.group)
    if dist is not None:
        dist.all_reduce(t, group=shard.group)


def _buffer(like: torch.Tensor, rows: int) -> torch.Tensor:
    """Zeros of ``rows`` rows shaped as ``like``, in a dtype every backend
    sums (f32 for bf16)."""
    wide = like.dtype in (torch.float32, torch.float64)
    b, c, _, w = like.shape
    return like.new_zeros((b, c, rows, w),
                          dtype=like.dtype if wide else torch.float32)


def _halos(h: int, n: int, needs: tuple) -> tuple:
    """Each rank's halo: the rows of its need inside ``[0, h)`` that it
    does not own, as ``(g0, g1, offset)`` runs of the exchange buffer, and
    the buffer's rows."""
    runs, total = [], 0
    for r, (a, b) in enumerate(needs):
        lo, hi = row_bounds(h, n, r)
        mine = []
        for g0, g1 in ((max(a, 0), min(b, lo)), (max(a, hi), min(b, h))):
            if g0 < g1:
                mine.append((g0, g1, total))
                total += g1 - g0
        runs.append(tuple(mine))
    return tuple(runs), total


class _FetchRows(torch.autograd.Function):
    """``fetch_rows``: forward the halo exchange, backward its transpose
    (each halo row's gradient added to its owner's)."""

    @staticmethod
    def forward(ctx, x, h, needs, shard):
        ctx.h, ctx.needs, ctx.shard, ctx.held = h, needs, shard, x.shape[2]
        lo, hi = shard.bounds(h)
        a, b = needs[shard.index]
        slab = x.new_zeros((x.shape[0], x.shape[1], b - a, x.shape[3]))
        s0, s1 = max(a, lo), min(b, hi)
        if s0 < s1:
            slab[:, :, s0 - a:s1 - a] = x[:, :, s0 - lo:s1 - lo]
        runs, total = _halos(h, shard.n, needs)
        if total:
            buf = _buffer(x, total)
            for run in runs:
                for g0, g1, off in run:
                    s0, s1 = max(g0, lo), min(g1, hi)
                    if s0 < s1:
                        buf[:, :, off + s0 - g0:off + s1 - g0] = \
                            x[:, :, s0 - lo:s1 - lo]
            _sum_(buf, shard)
            for g0, g1, off in runs[shard.index]:
                slab[:, :, g0 - a:g1 - a] = buf[:, :, off:off + g1 - g0]
        return slab

    @staticmethod
    def backward(ctx, g):
        h, needs, shard = ctx.h, ctx.needs, ctx.shard
        lo, hi = shard.bounds(h)
        a, b = needs[shard.index]
        gx = g.new_zeros((g.shape[0], g.shape[1], ctx.held, g.shape[3]))
        s0, s1 = max(a, lo), min(b, hi)
        if s0 < s1:
            gx[:, :, s0 - lo:s1 - lo] += g[:, :, s0 - a:s1 - a]
        runs, total = _halos(h, shard.n, needs)
        if total:
            buf = _buffer(g, total)
            for g0, g1, off in runs[shard.index]:
                buf[:, :, off:off + g1 - g0] = g[:, :, g0 - a:g1 - a]
            _sum_(buf, shard)
            for run in runs:
                for g0, g1, off in run:
                    s0, s1 = max(g0, lo), min(g1, hi)
                    if s0 < s1:
                        gx[:, :, s0 - lo:s1 - lo] += \
                            buf[:, :, off + s0 - g0:off + s1 - g0]
        return gx, None, None, None


def fetch_rows(x: torch.Tensor, h: int, needs: tuple,
               shard: RowShard) -> torch.Tensor:
    """The global rows ``needs[shard.index] = (a, b)`` of the NCHW tensor
    of height ``h`` whose rows the ranks hold (``x``: this rank's), zeros
    outside ``[0, h)``.  ``needs`` lists every rank's ``(a, b)``: each
    rank of the group calls it with the same ``needs``, in the same
    order."""
    return _FetchRows.apply(x, h, needs, shard)


class _GatherRows(torch.autograd.Function):
    """``gather_rows``: forward every rank's rows, backward the rank's own
    rows of the gradient (every rank computes the same loss from them)."""

    @staticmethod
    def forward(ctx, x, h, shard):
        lo, hi = shard.bounds(h)
        ctx.rows, ctx.held = (lo, hi), x.shape[2]
        full = _buffer(x, h)
        full[:, :, lo:hi] = x[:, :, :hi - lo]
        _sum_(full, shard)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        gx = g.new_zeros((g.shape[0], g.shape[1], ctx.held, g.shape[3]))
        gx[:, :, :hi - lo] = g[:, :, lo:hi]
        return gx, None, None


def gather_rows(x: torch.Tensor, h: int, shard: RowShard) -> torch.Tensor:
    """The whole NCHW tensor of height ``h`` on every rank of the group."""
    return _GatherRows.apply(x, h, shard)


def window_rows(x: torch.Tensor, h: int, h_out: int, stride: int,
                start: int, span: int, shard: RowShard) -> torch.Tensor:
    """The input rows that the rank's output rows of an op of output
    height ``h_out`` read, output row ``o`` reading ``[o stride + start,
    o stride + start + span)``; a rank with no output row gets ``span``
    zero rows from past the end (its phantom row's input)."""
    needs = []
    for r in range(shard.n):
        o0, o1 = row_bounds(h_out, shard.n, r)
        needs.append((o0 * stride + start, (o1 - 1) * stride + start + span)
                     if o0 < o1 else (h, h + span))
    return fetch_rows(x, h, tuple(needs), shard)


def sp_avg_pool(x: torch.Tensor, h: int, shard: RowShard) -> tuple:
    """``avg_pool(x, 2)`` over the rank's rows: ``(rows, height)``."""
    h_out = h // 2
    return avg_pool(window_rows(x, h, h_out, 2, 0, 2, shard), 2), h_out


def sp_shift_rows(x: torch.Tensor, h: int, h_out: int, top: int,
                  shard: RowShard) -> torch.Tensor:
    """Output row ``o`` of height ``h_out`` is input row ``o - top``, zero
    outside: a pad of ``top`` rows above (and ``h_out - h - top`` below),
    or a crop to the first ``h_out``."""
    if (h_out, top) == (h, 0):
        return x
    return window_rows(x, h, h_out, 1, -top, 1, shard)


def sp_stem(model: TTnetImageNet, x: torch.Tensor, h: int,
            shard: RowShard) -> tuple:
    """``models/ttnet_imagenet.py::stem`` over the rank's rows of NCHW
    images of height ``h``: ``(bits, height)``."""
    conv = model.stem_conv
    if model.cfg.stem_impl == "s2d":
        h_out = (h + sum(stem_pad(h))) // 4 - 3
        slab = window_rows(x, h, h_out, 4, -6, 16, shard)
        y = s2d_conv(F.pad(slab, (*stem_pad(x.shape[3]), 0, 0)),
                     conv.weight)
        if conv.bias is not None:
            y = y + conv.bias.view(1, -1, 1, 1)
    else:
        x, h = sp_avg_pool(x, h, shard)
        h_out = (h + 6 - 7) // 2 + 1
        slab = window_rows(x, h, h_out, 2, -3, 7, shard)
        y = conv2d(F.pad(slab, (3, 3, 0, 0)), conv.weight, conv.bias,
                   stride=2)
    return binarize01_act(batch_norm(model.stem_bn, y)), h_out


def sp_block_tt(block, x: torch.Tensor, h: int, shard: RowShard,
                slabs: dict | None = None) -> tuple:
    """``block_tt`` (eval) over the rank's rows: ``(rows, height)``.  A
    block that neither pads, strides nor spans rows runs on them as it
    is; another on the input rows of its output rows, padded in width
    only.  ``slabs`` shares the exchange between blocks that read the
    same rows."""
    cfg = block.cfg
    kh = _as_pair(cfg.k)[0]
    p, s = cfg.padding, cfg.stride
    if (kh, s, p) == (1, 1, 0):
        return block_tt(block, x), h
    slabs = {} if slabs is None else slabs
    if (kh, s, p) not in slabs:
        h_out = (h + 2 * p - kh) // s + 1
        slabs[kh, s, p] = window_rows(x, h, h_out, s, -p, kh, shard), h_out
    slab, h_out = slabs[kh, s, p]
    return block_tt(block, F.pad(slab, (p, p, 0, 0)), pre_padded=True), \
        h_out


def sp_multihead_block(block, x: torch.Tensor, h: int,
                       shard: RowShard) -> tuple:
    """``models/multihead.py::multihead_block`` (eval, ``T = 0``) over the
    rank's rows: the heads, ``reconcile_heads``'s re-pools, fix-up pads
    and crop on global heights, the interleave and the fuse head."""
    cfg = block.cfg
    slabs, outs, hs = {}, {}, {}
    for i in (1, 2, 3):
        outs[i], hs[i] = sp_block_tt(block.head(i), x, h, shard, slabs)
    if cfg.stride == 2:
        for i, src, hi in ((4, x, h), (3, outs[3], hs[3])):
            pooled, hs[i] = sp_avg_pool(src, hi, shard)
            outs[i] = binarize01_act(pooled - 0.5, cfg.T)
    else:
        outs[4], hs[4] = x, h
    for idx, (l, r, t, b) in FIXUP_RULES[cfg.fixup](
            x.shape[3], outs[1].shape[3]).items():
        outs[idx] = sp_shift_rows(F.pad(outs[idx], (l, r, 0, 0)), hs[idx],
                                  hs[idx] + t + b, t, shard)
        hs[idx] += t + b
    th = min(hs.values())
    tw = min(o.shape[3] for o in outs.values())
    cat = torch.cat([sp_shift_rows(outs[i], hs[i], th, 0, shard)[..., :tw]
                     for i in sorted(outs)], dim=1)
    if not cfg.fuse:
        return cat, th
    return sp_block_tt(block.Block_convf, channel_interleave(cat, cfg.cpt),
                       th, shard)


def sp_ttnet_imagenet_apply(model: TTnetImageNet, x: torch.Tensor,
                            shard: RowShard) -> torch.Tensor:
    """The eval forward over the rank's rows of NHWC images (their height
    ``n`` times the rank's rows): the whole logits, the same on every
    rank of the model group."""
    h = x.shape[1] * shard.n
    y, h = sp_stem(model, _nchw(x, model), h, shard)
    for block in model.blocks:
        y, h = sp_multihead_block(block, y, h, shard)
    y, h = sp_avg_pool(y, h, shard)
    return classifier_scale(model.classifier,
                            flatten(gather_rows(y, h, shard)))


def sp_family(config) -> None:
    """Raise ``SP_FAMILY`` unless ``config`` builds a model of the port's
    ``--sp`` families."""
    if not isinstance(config, TTnetImageNetConfig):
        raise ValueError(SP_FAMILY.format(type(config).__name__))


def sp_forward(model: TTnetImageNet, shard: RowShard):
    """``x -> logits`` of ``model`` over a rank's rows (``SP_FAMILY``
    outside the port's ``--sp`` families)."""
    sp_family(model.cfg)
    return functools.partial(sp_ttnet_imagenet_apply, model, shard=shard)
