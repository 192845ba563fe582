"""Truth-table extraction (counterpart of ``scale_imagenet_tpu/compile/truth_table.py:59,81``):
evaluate a Block_TT on all 2^n binary input patterns.

Bit order matches the reference: ``format(x, 'b').zfill(n)`` MSB-first,
channel-major ``(channel, kh, kw)``; each pattern is tiled across the
``groupsici`` groups so one batched pass evaluates every filter of every
group.  Patterns are evaluated UNPADDED (one valid conv position), so row r
of a filter's table is exactly its response to window bits r.  Patterns
are generated chunk by chunk on the block's device.  Tables are enumerated
under ``exact_numerics()`` (``truth_table.py:89,107``): exact erf and no
fused kernel, whatever ``config.performance`` says, so a table does not
depend on the switch.  Minimisation and the
artifact files come with the gate compiler (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from ..config import exact_numerics
from ..models.block_tt import BlockTT, BlockTTConfig, _as_pair, block_tt

MAX_BITS = 24


def _patterns(cfg: BlockTTConfig, lo: int, hi: int, device,
              dtype) -> torch.Tensor:
    """Patterns ``lo..hi-1`` as NCHW ``(hi - lo, in_planes, kh, kw)``."""
    kh, kw = _as_pair(cfg.k)
    ci = cfg.in_planes // cfg.groupsici       # channels seen per filter
    n = kh * kw * ci
    codes = torch.arange(lo, hi, device=device, dtype=torch.int64)
    shifts = torch.arange(n - 1, -1, -1, device=device, dtype=torch.int64)
    bits = ((codes[:, None] >> shifts[None, :]) & 1).to(dtype)
    return bits.reshape(-1, ci, kh, kw).repeat(1, cfg.groupsici, 1, 1)


def enumerate_patterns(cfg: BlockTTConfig, device="cpu") -> torch.Tensor:
    """All 2^n patterns as ``(2^n, kh, kw, in_planes)`` float32 NHWC — the
    JAX ``enumerate_patterns`` layout."""
    n = cfg.n_bits
    if n > MAX_BITS:
        raise ValueError(f"n={n} bits: 2^n enumeration infeasible")
    return _patterns(cfg, 0, 2 ** n, device, torch.float32).permute(
        0, 2, 3, 1).contiguous()


@torch.no_grad()
def block_truth_table(block: BlockTT, chunk: int = 8192) -> torch.Tensor:
    """``(2^n, out_planes)`` response table of an eval-mode block, on the
    block's device and in its dtype."""
    cfg = block.cfg
    n = cfg.n_bits
    if n > MAX_BITS:
        raise ValueError(f"n={n} bits: 2^n enumeration infeasible")
    w = block.conv1.weight
    outs = []
    with exact_numerics():
        for lo in range(0, 2 ** n, chunk):
            x = _patterns(cfg, lo, min(lo + chunk, 2 ** n), w.device,
                          w.dtype)
            outs.append(block_tt(block, x, pre_padded=True)[:, :, 0, 0])
    return torch.cat(outs)
