"""Spatial partitioning over ranks, ``--sp`` (counterpart of
``scale_imagenet_tpu/parallel/sharding.py::spatial_sharding`` and of
``train/steps.py::make_eval_step(spatial=True)``): the row ops.  The
families' sharded forwards and their dispatch table are in
``sp_models.py``.

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
backward's too.  A rank's tensor cannot tell the global height (15 rows
at n = 2 may be 29 or 30, and heads branch to different heights), so
every op here takes it, ``h``, and returns the output's: ``(x, h, shard)
-> (y, h_out)``.

**One exchange per row-mixing op.**  Each op that mixes rows computes
only the rank's own output rows.  Output row ``o`` reads the input rows
``[o s + a, o s + a + k)`` (``window_rows``); ``fetch_rows`` gives the
rank those rows, with the op's own pad value outside ``[0, h)`` (zero,
or -inf for a padded max pool), and the unmodified op runs on them,
padded in width only:

* a conv or pool of kernel height ``k``, stride ``s`` and padding ``p``
  (``sp_window``: ``sp_conv2d``, ``sp_avg_pool``, ``sp_max_pool``, the
  cells of ``sp_cell`` and ``sp_block_tt``): ``a = -p``; a k = 1 stride-1
  unpadded one is row-local and exchanges nothing;
* a pad of ``top`` rows above or a crop (``sp_zero_pad2d``; negative
  pads crop, as in ``F.pad``): ``s = 1, a = -top, k = 1``, the crops of
  ``[:, :, :-1, :-1]`` being a global crop of the last row, not of each
  rank's; the crop of several outputs to the smallest (``sp_crop_cat``)
  likewise;
* the s2d stem (``sp_models.py``): ``s = 4, a = -6, k = 16``.

The rest is row-local and runs on the rank's rows as it is: BN in eval,
the activations and quantizers, the k = 1 heads (the fused pointwise
kernel among them), the channel interleave.  Heads 1 and 2 of a
multi-head block read the same rows where their kernels agree, and share
one exchange.

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
not contiguous in the features: ``sp_flatten`` gathers the whole
features on every model rank (``gather_rows``), and the classifier runs
whole on each, the same function on the same features as the
one-process forward.  Its backward keeps the rank's own rows of the
gradient: every model rank holds the same loss, and a sum over the group
would count it ``n`` times.

**Coin flips.**  ``RowNoise`` stands in for a site's ``NoiseKey``: it
draws the site's flips at the global shape from the same key and hands
the rank its rows, so a stochastic forward flips exactly the bits the
unsharded one flips.

**Intervals** (``--certify``): ``sp_interval`` runs a row op on both
bounds at once (stacked on the batch axis, one exchange);
``sp_interval_conv2d`` and ``sp_interval_block_tt`` then take the two
bounds per conv of ``robust/interval.py`` on the rank's slab.  The
bounds are exact; an ``Interval``'s ``loss`` (the activation-stability
term of training) is the rank's own and is not summed over the group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..layers.conv import conv2d
from ..layers.pool import avg_pool, flatten
from ..models.block_tt import _as_pair, block_tt
from ..models.multihead import FIXUP_RULES, channel_interleave
from ..ops.binarize import binarize01_act
from ..robust.interval import Interval, interval_block_tt, interval_conv2d
from .data_parallel import _dist

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
    model axis (``scale_imagenet_tpu/main.py:1042-1045``), stored as a
    whole batch is (so that the forward's NCHW view of them is
    ``channels_last``, as the whole batch's is)."""
    h = images.shape[1]
    if h % shard.n:
        raise ValueError(SP_HEIGHT.format(h, shard.n))
    lo, hi = shard.bounds(h)
    return images[:, lo:hi].contiguous()


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


def _memory_format(x: torch.Tensor):
    """``channels_last`` for an NCHW tensor stored NHWC (the images'
    permuted view and what the ops make from it), else contiguous."""
    if not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _FetchRows(torch.autograd.Function):
    """``fetch_rows``: forward the halo exchange, backward its transpose
    (each halo row's gradient added to its owner's)."""

    @staticmethod
    def forward(ctx, x, h, needs, shard, fill):
        ctx.h, ctx.needs, ctx.shard, ctx.held = h, needs, shard, x.shape[2]
        lo, hi = shard.bounds(h)
        a, b = needs[shard.index]
        # a phantom row's input (a need past the end) is zeros, whatever
        # the op pads with: nothing reads its output.  The slab keeps x's
        # memory format, so that the op on it takes the algorithm (and
        # rounding) that it takes on the whole tensor
        slab = torch.empty((x.shape[0], x.shape[1], b - a, x.shape[3]),
                           dtype=x.dtype, device=x.device,
                           memory_format=_memory_format(x))
        slab.fill_(fill if a < h else 0.0)
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
        return gx, None, None, None, None


def fetch_rows(x: torch.Tensor, h: int, needs: tuple, shard: RowShard,
               fill: float = 0.0) -> torch.Tensor:
    """The global rows ``needs[shard.index] = (a, b)`` of the NCHW tensor
    of height ``h`` whose rows the ranks hold (``x``: this rank's),
    ``fill`` outside ``[0, h)``.  ``needs`` lists every rank's ``(a, b)``:
    each rank of the group calls it with the same ``needs``, in the same
    order."""
    return _FetchRows.apply(x, h, needs, shard, fill)


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
                start: int, span: int, shard: RowShard,
                fill: float = 0.0) -> torch.Tensor:
    """The input rows that the rank's output rows of an op of output
    height ``h_out`` read, output row ``o`` reading ``[o stride + start,
    o stride + start + span)``, ``fill`` outside ``[0, h)``; a rank with
    no output row gets ``span`` zero rows from past the end (its phantom
    row's input)."""
    needs = []
    for r in range(shard.n):
        o0, o1 = row_bounds(h_out, shard.n, r)
        needs.append((o0 * stride + start, (o1 - 1) * stride + start + span)
                     if o0 < o1 else (h, h + span))
    return fetch_rows(x, h, tuple(needs), shard, fill)


def sp_window(x: torch.Tensor, h: int, shard: RowShard, k, stride=1,
              padding=0, fill: float = 0.0) -> tuple:
    """The rank's input slab of a conv or pool of kernel ``k``, ``stride``
    and (symmetric) ``padding``: its output rows' input rows, ``fill``
    past the global edges, padded by ``fill`` in width only; ``(slab,
    output height)``.  The op then runs on the slab unpadded.  A k = 1
    stride-1 unpadded op is row-local: the rows come back as they are."""
    kh = _as_pair(k)[0]
    sh = _as_pair(stride)[0]
    ph, pw = _as_pair(padding)
    h_out = (h + 2 * ph - kh) // sh + 1
    if (kh, sh, ph) != (1, 1, 0):
        x = window_rows(x, h, h_out, sh, -ph, kh, shard, fill)
    if pw:
        x = F.pad(x, (pw, pw, 0, 0), value=fill)
    return x, h_out


def sp_conv2d(x: torch.Tensor, h: int, shard: RowShard,
              weight: torch.Tensor, bias: torch.Tensor | None = None,
              stride=1, padding=0, groups: int = 1) -> tuple:
    """``layers/conv.py::conv2d`` over the rank's rows: ``(rows,
    height)``."""
    slab, h_out = sp_window(x, h, shard, weight.shape[2:], stride, padding)
    return conv2d(slab, weight, bias, stride, groups=groups), h_out


def sp_avg_pool(x: torch.Tensor, h: int, shard: RowShard, window=2,
                stride=None, padding: int = 0) -> tuple:
    """``avg_pool`` (zero ``padding`` counted, as a zero pad before an
    unpadded pool) over the rank's rows: ``(rows, height)``."""
    stride = window if stride is None else stride
    slab, h_out = sp_window(x, h, shard, window, stride, padding)
    return avg_pool(slab, window, stride), h_out


def sp_max_pool(x: torch.Tensor, h: int, shard: RowShard, window=2,
                stride=None, padding: int = 0) -> tuple:
    """``F.max_pool2d`` over the rank's rows, its implicit pad -inf past
    the global edges: ``(rows, height)``."""
    stride = window if stride is None else stride
    slab, h_out = sp_window(x, h, shard, window, stride, padding,
                            fill=-float("inf"))
    return F.max_pool2d(slab, window, stride), h_out


def sp_shift_rows(x: torch.Tensor, h: int, h_out: int, top: int,
                  shard: RowShard) -> torch.Tensor:
    """Output row ``o`` of height ``h_out`` is input row ``o - top``, zero
    outside: a pad of ``top`` rows above (and ``h_out - h - top`` below),
    or a crop to the first ``h_out``."""
    if (h_out, top) == (h, 0):
        return x
    return window_rows(x, h, h_out, 1, -top, 1, shard)


def sp_zero_pad2d(x: torch.Tensor, h: int, shard: RowShard,
                  pad: tuple) -> tuple:
    """``zero_pad2d(x, (left, right, top, bottom))`` over the rank's rows,
    a negative entry cropping as in ``F.pad`` (``(0, -1, 0, -1)`` is the
    families' ``[:, :, :-1, :-1]``): ``(rows, height)``."""
    left, right, top, bottom = pad
    h_out = h + top + bottom
    return sp_shift_rows(F.pad(x, (left, right, 0, 0)), h, h_out, top,
                         shard), h_out


def sp_crop_cat(outs, hs, shard: RowShard) -> tuple:
    """Each output cropped bottom-right to the smallest (global) height
    and width, concatenated on channels: ``(rows, height)``."""
    th = min(hs)
    tw = min(o.shape[3] for o in outs)
    return torch.cat([sp_shift_rows(o, ho, th, 0, shard)[..., :tw]
                      for o, ho in zip(outs, hs)], dim=1), th


def sp_flatten(x: torch.Tensor, h: int, shard: RowShard) -> torch.Tensor:
    """``flatten`` of the whole features, on every rank of the group."""
    return flatten(gather_rows(x, h, shard))


class RowNoise:
    """A draw site's ``NoiseKey`` under ``--sp``: ``draw(x)`` of the rank's
    rows ``x`` of an output of global height ``h`` draws the site's flips
    at the global shape from ``key`` and returns the rank's rows of them
    (zeros for a phantom row)."""

    def __init__(self, key, h: int, shard: RowShard):
        self.key, self.h, self.shard = key, h, shard

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.shard.bounds(self.h)
        if lo == hi:
            return torch.zeros_like(x)
        b, c, _, w = x.shape
        return self.key.draw(x.new_empty((b, c, self.h, w)))[:, :, lo:hi]


def row_noise(key, h: int, shard: RowShard) -> RowNoise | None:
    return None if key is None else RowNoise(key, h, shard)


def sp_cell(fn, block, x: torch.Tensor, h: int, shard: RowShard,
            **kw) -> tuple:
    """A conv cell ``fn(block, x, pre_padded=...)`` whose first conv is
    ``block.cfg``'s ``k``, ``stride`` and ``padding`` and whose rest is
    row-local (``block_resnet``, ``block_resnet_bn``,
    ``block_resnet_float``) over the rank's rows: ``(rows, height)``."""
    cfg = block.cfg
    slab, h_out = sp_window(x, h, shard, cfg.k, cfg.stride, cfg.padding)
    return fn(block, slab, pre_padded=True, **kw), h_out


def sp_block_tt(block, x: torch.Tensor, h: int, shard: RowShard,
                slabs: dict | None = None, noise=None) -> tuple:
    """``block_tt`` (eval) over the rank's rows: ``(rows, height)``.  A
    block that neither pads, strides nor spans rows runs on them as it
    is (the fused kernel's gate is its own); another on the input rows of
    its output rows, padded in width only.  ``slabs`` shares the exchange
    between blocks that read the same rows; ``noise`` is the site's
    ``NoiseKey``."""
    cfg = block.cfg
    kh = _as_pair(cfg.k)[0]
    p, s = cfg.padding, cfg.stride
    if (kh, s, p) == (1, 1, 0):
        return block_tt(block, x, noise=row_noise(noise, h, shard)), h
    slabs = {} if slabs is None else slabs
    if (kh, s, p) not in slabs:
        slabs[kh, s, p] = sp_window(x, h, shard, kh, s, (p, p))
    slab, h_out = slabs[kh, s, p]
    return block_tt(block, slab, pre_padded=True,
                    noise=row_noise(noise, h_out, shard)), h_out


def sp_multihead_block(block, x: torch.Tensor, h: int, shard: RowShard,
                       noise=None) -> tuple:
    """``models/multihead.py::multihead_block`` (eval) over the rank's
    rows: the heads, ``reconcile_heads``'s re-pools, fix-up pads and crop
    on global heights, the interleave and the fuse head; ``noise`` keys
    the dead zones as ``multihead_block`` does."""
    cfg = block.cfg
    keys = {i: None if noise is None else noise.child(i)
            for i in range(1, 7)}
    slabs, outs, hs = {}, {}, {}
    for i in (1, 2, 3):
        outs[i], hs[i] = sp_block_tt(block.head(i), x, h, shard, slabs,
                                     keys[i])
    if cfg.stride == 2:
        for i, src, hi in ((4, x, h), (3, outs[3], hs[3])):
            pooled, hs[i] = sp_avg_pool(src, hi, shard)
            outs[i] = binarize01_act(pooled - 0.5, cfg.T, row_noise(
                keys[4 if i == 4 else 5], hs[i], shard))
    else:
        outs[4], hs[4] = x, h
    for idx, pad in FIXUP_RULES[cfg.fixup](x.shape[3],
                                           outs[1].shape[3]).items():
        outs[idx], hs[idx] = sp_zero_pad2d(outs[idx], hs[idx], shard, pad)
    order = sorted(outs)
    cat, th = sp_crop_cat([outs[i] for i in order], [hs[i] for i in order],
                          shard)
    if not cfg.fuse:
        return cat, th
    return sp_block_tt(block.Block_convf, channel_interleave(cat, cfg.cpt),
                       th, shard, noise=keys[6])


# ---------------------------------------------------------------------------
# intervals


def sp_interval(op, iv: Interval, h: int, shard: RowShard, *args,
                **kw) -> tuple:
    """The row op ``op(x, h, shard, ...) -> (rows, height)`` on both bounds
    of ``iv`` in one exchange: ``(Interval, height)``."""
    both, h_out = op(torch.cat([iv.vmin, iv.vmax]), h, shard, *args, **kw)
    vmin, vmax = both.chunk(2)
    return Interval(vmin, vmax, iv.loss), h_out


def sp_interval_conv2d(iv: Interval, h: int, shard: RowShard,
                       weight: torch.Tensor, stride=1, padding=0,
                       groups: int = 1,
                       bias: torch.Tensor | None = None) -> tuple:
    """``interval_conv2d`` over the rank's rows: ``(Interval, height)``."""
    slab, h_out = sp_interval(sp_window, iv, h, shard, weight.shape[2:],
                              stride, padding)
    return interval_conv2d(slab, weight, stride, 0, groups, bias), h_out


def sp_interval_block_tt(block, iv: Interval, h: int,
                         shard: RowShard) -> tuple:
    """``interval_block_tt`` over the rank's rows: ``(Interval,
    height)``."""
    cfg = block.cfg
    slab, h_out = sp_interval(sp_window, iv, h, shard, cfg.k, cfg.stride,
                              cfg.padding)
    return interval_block_tt(block, slab, pre_padded=True), h_out


def sp_interval_flatten(iv: Interval, h: int, shard: RowShard) -> Interval:
    """``interval_flatten`` of the whole bounds, on every rank."""
    vmin, vmax = sp_flatten(torch.cat([iv.vmin, iv.vmax]), h,
                            shard).chunk(2)
    return Interval(vmin, vmax, iv.loss)
