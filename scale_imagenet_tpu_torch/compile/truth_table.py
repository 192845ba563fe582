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
depend on the switch.

``extract_block_tables`` and ``compile_model_truth_tables`` (``:116,215``)
minimize each filter's table and write the artifacts (CSVs, DNF/CNF
expressions and DIMACS for n <= 12; packed tables, cube arrays and DIMACS
above), with the JAX package's file names and contents.  The per-filter
minimizations of a block run on a thread pool (``logic.map_in_order``),
collected in filter order.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..config import exact_numerics
from ..models.block_tt import BlockTT, BlockTTConfig, _as_pair, block_tt
from ..native import pack_table_bits
from .logic import count_gates, dimacs_from_covers, map_in_order, \
    minimize_cache, minimize_packed, minimize_truth_table, \
    save_filter_artifacts

MAX_BITS = 24

# scoped memo for block_truth_table (see table_cache below)
_TABLE_CACHE: dict | None = None


@contextlib.contextmanager
def table_cache():
    """Memoize ``block_truth_table`` and ``logic.minimize_packed`` for the
    duration of the block: a ``--mode compile --verilog`` run extracts
    artifacts AND gate-compiles the same blocks, so each 2^n enumeration
    and each n > 12 filter's espresso runs once.  Tables are keyed on the
    block's identity and the chunk; the blocks must stay alive and
    unchanged for the scope (ids are unique only while the objects are)."""
    global _TABLE_CACHE
    prev, _TABLE_CACHE = _TABLE_CACHE, {}
    try:
        with minimize_cache():
            yield
    finally:
        _TABLE_CACHE = prev


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
    block's device and in its dtype (memoized inside ``table_cache()``)."""
    cfg = block.cfg
    n = cfg.n_bits
    if n > MAX_BITS:
        raise ValueError(f"n={n} bits: 2^n enumeration infeasible")
    key = (id(block), chunk)
    if _TABLE_CACHE is not None and key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    w = block.conv1.weight
    outs = []
    with exact_numerics():
        for lo in range(0, 2 ** n, chunk):
            x = _patterns(cfg, lo, min(lo + chunk, 2 ** n), w.device,
                          w.dtype)
            outs.append(block_tt(block, x, pre_padded=True)[:, :, 0, 0])
    table = torch.cat(outs)
    if _TABLE_CACHE is not None:
        _TABLE_CACHE[key] = table
    return table


def _minimize_filter(job):
    """One filter's minimizations, one a non-default value (on the pool):
    espresso cube covers for n > 12, minimized expressions below."""
    col, n = job
    if n > 12:
        return {float(v): minimize_packed(
            pack_table_bits((col == v).astype(np.uint8)), n)
            for v in np.unique(col)[1:]}
    return {float(v): minimize_truth_table(np.nonzero(col == v)[0].tolist(),
                                           n)
            for v in np.unique(col)[1:]}


def extract_block_tables(block: BlockTT, out_dir: str | None = None,
                         block_id: int = 0, sub_block_id: int = 0,
                         minimize: bool = True, max_minimize_bits: int = 12,
                         threads: int | None = None) -> dict:
    """Per-filter artifacts of one block (``truth_table.py:116``):
    ``{filter: {"table", "constant"}}`` for a constant filter, else
    ``{"table"}`` plus ``"expressions"`` (n <= 12: one minimized DNF/CNF a
    non-default value) or ``"term_sets"`` (n > 12: espresso cube covers).
    A column with more than 16 values (a last/ReLU block) is continuous:
    exported as its table, not minimized."""
    cfg = block.cfg
    n = cfg.n_bits
    table = block_truth_table(block).cpu().numpy()
    results, continuous, jobs = {}, set(), []
    for f in range(table.shape[1]):
        col = table[:, f]
        uniq = np.unique(col)
        if len(uniq) == 1:
            results[f] = {"table": col, "constant": float(uniq[0])}
            continue
        results[f] = {"table": col}
        if len(uniq) > 16:
            continuous.add(f)
        elif minimize and n <= max_minimize_bits:
            jobs.append(f)
    minimized = map_in_order(_minimize_filter,
                             [(table[:, f], n) for f in jobs], threads)
    for f, res in zip(jobs, minimized):
        results[f]["term_sets" if n > 12 else "expressions"] = res
    if out_dir:
        for f, entry in results.items():
            col = entry["table"]
            if "constant" in entry:
                save_filter_artifacts(out_dir, block_id, sub_block_id, f,
                                      col, n, constant=entry["constant"])
            elif f in continuous:
                os.makedirs(out_dir, exist_ok=True)
                np.save(os.path.join(
                    out_dir, f"table_block{block_id}_filter_{f}"
                    f"_sousblock_{sub_block_id}_continuous.npy"), col)
            elif "term_sets" in entry:
                _save_packed_artifacts(out_dir, block_id, sub_block_id, f,
                                       col, entry["term_sets"])
            else:
                save_filter_artifacts(out_dir, block_id, sub_block_id, f,
                                      col, n,
                                      expressions=entry.get("expressions"))
    return results


def _save_packed_artifacts(out_dir: str, block_id: int, sub_block_id: int,
                           filter_id: int, col: np.ndarray,
                           term_sets: dict):
    """Compact artifacts for large-n filters: the packed table plus the
    minimized (value, mask) cube arrays per output value."""
    os.makedirs(out_dir, exist_ok=True)
    base = f"block{block_id}_filter_{filter_id}_sousblock_{sub_block_id}"
    np.save(os.path.join(out_dir, f"packed_table_{base}.npy"),
            pack_table_bits((col != col.flat[0]).astype(np.uint8)))
    n = int(np.log2(len(col)))
    for v, ts in term_sets.items():
        np.save(os.path.join(out_dir, f"dnf_terms_{base}_value_{v}.npy"),
                np.asarray(ts["terms"], dtype=np.uint32))
        np.save(os.path.join(out_dir, f"cnf_terms_{base}_value_{v}.npy"),
                np.asarray(ts["cnf_terms"], dtype=np.uint32))
        with open(os.path.join(out_dir,
                               f"dimacs_{base}_value_{v}.cnf"), "w") as f:
            f.write(dimacs_from_covers(
                ts["terms"], ts["cnf_terms"], n,
                comment=f"block {block_id} filter {filter_id} value {v}"))


def model_block_items(model) -> list:
    """``(name, BlockTT)`` of every Block_TT of every multi-head block, in
    ``--mode compile``'s order: ``block{i}_conv{h}``, then
    ``block{i}_convf`` where the block has a fuse head (the VGG-stem
    variant's has none, ``scale_imagenet_tpu/main.py:816-826``)."""
    items = []
    for i, block in enumerate(model.blocks):
        items += [(f"block{i}_conv{h}", block.head(h))
                  for h in sorted(block.cfg.head_cfgs())]
        if block.cfg.fuse:
            items.append((f"block{i}_convf", block.Block_convf))
    return items


def compile_model_truth_tables(block_items, out_dir: str,
                               minimize: bool = True,
                               max_minimize_bits: int = 12,
                               threads: int | None = None) -> dict:
    """Compile every ``(name, BlockTT)`` item; returns the summary with the
    total gate count (the reference's headline metric)."""
    os.makedirs(out_dir, exist_ok=True)
    summary = {"blocks": {}, "total_gates": 0}
    for bi, (name, block) in enumerate(block_items):
        res = extract_block_tables(block, out_dir=os.path.join(out_dir, name),
                                   block_id=bi, minimize=minimize,
                                   max_minimize_bits=max_minimize_bits,
                                   threads=threads)
        gates = 0
        for entry in res.values():
            for expr in (entry.get("expressions") or {}).values():
                gates += count_gates(expr["dnf"])
            for ts in (entry.get("term_sets") or {}).values():
                gates += ts["gates"]
        summary["blocks"][name] = {"filters": len(res),
                                   "n_bits": block.cfg.n_bits,
                                   "gates": gates}
        summary["total_gates"] += gates
    return summary
