"""Compiled-LUT archives (counterpart of ``scale_imagenet_tpu/compile/lut_store.py``).

Serving wants to load a compiled network, not enumerate 2^n patterns per
head again.  One ``.npz`` holds every block's tables in the JAX package's
format, version ``LUT_FORMAT_VERSION`` = 2 and the same keys, so an archive
written by either package loads in the other:

    __format_version__   int64
    __params_digest__    uint8 bytes of the weights' SHA-256 hex digest
    b{i}_h{h}_table      (out_planes, 2^n) float32 (bits, or floats of a
    b{i}_convf_table      last block)
    b{i}_h{h}_packed     the JAX kernel layout (G, F, S, 128): int32 bit
    b{i}_convf_packed     words, or float32 rows; written where the JAX
                          compiler writes it, ignored on load

The port packs its own layout from ``*_table`` at load (float tables
filter-minor ``(G, 2^n, F)``), and ``MultiHeadLUT`` concatenates the merged
heads' words once, as compile does.  The digest is the
JAX package's ``params_digest`` of the same weights: the port rebuilds
the JAX-layout ``(params, state)`` tree (``convert.jax_trees``) and hashes
it in JAX's sorted-key order with JAX's ``keystr`` path text, so a stale
archive, compiled from other weights, is refused in both packages.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import warnings

import numpy as np
import torch

from ..convert.from_jax import jax_trees
from ..kernels.lut_gather import pack_bit_table, pack_float_table
from .lut_eval import BlockLUT, MultiHeadLUT

#: bump when the compiler or the packing changes so that saved archives
#: are no longer equivalent (the JAX package's constant)
LUT_FORMAT_VERSION = 2

# the JAX compiler writes a kernel layout only within its kernels' range
_JAX_MAX_BIT_ENTRIES = 16 * 4096
_JAX_MAX_FLOAT_TABLE_BYTES = 4 << 20


def _leaves(tree: dict, path: str = ""):
    """``(keystr, leaf)`` in JAX's flatten order: dict keys sorted."""
    for k in sorted(tree):
        p = f"{path}[{k!r}]"
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], p)
        else:
            yield p, tree[k]


def params_digest(params: dict, state: dict | None = None) -> str:
    """SHA-256 over JAX-layout ``(params, state)`` trees: leaf paths,
    dtypes, shapes and bytes, as ``lut_store.py:36``."""
    h = hashlib.sha256()
    for tree in (params, state):
        if tree is None:
            continue
        for path, leaf in _leaves(tree):
            a = np.asarray(leaf)
            h.update(path.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def model_digest(model) -> str:
    """The JAX package's digest of a port model's weights."""
    return params_digest(*jax_trees(model))


def _table(lut: BlockLUT) -> torch.Tensor:
    """The ``(out_planes, 2^n)`` table back from the packed layout."""
    entries = 2 ** lut.cfg.n_bits
    if lut.cfg.last:                                         # (G, V, F)
        return lut.packed.permute(0, 2, 1).reshape(-1, entries)
    g, f, w = lut.packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=lut.packed.device)
    bits = (lut.packed.unsqueeze(-1) >> shifts) & 1          # (G, F, W, 32)
    return bits.reshape(g * f, 32 * w)[:, :entries].float()


def _jax_packed(lut: BlockLUT, table: np.ndarray):
    """The JAX kernel layout ``(G, F, S, 128)``, or None where the JAX
    compiler writes none."""
    g = lut.packed.shape[0]
    f = table.shape[0] // g
    entries = table.shape[1]
    if lut.cfg.last:
        if entries * 4 > _JAX_MAX_FLOAT_TABLE_BYTES:
            return None
        rows = -(-entries // 128)
        vals = np.zeros((g, f, rows * 128), np.float32)
        vals[:, :, :entries] = table.reshape(g, f, entries)
        return vals.reshape(g, f, rows, 128)
    if entries > _JAX_MAX_BIT_ENTRIES:
        return None
    return lut.packed.cpu().numpy().reshape(g, f, -1, 128)


def save_luts(path: str, luts: list[MultiHeadLUT], model) -> None:
    """Write ``luts`` (compiled from ``model``) to ``path``, atomically: a
    kill mid-write leaves no truncated archive at ``path``."""
    arrs = {"__format_version__": np.int64(LUT_FORMAT_VERSION),
            "__params_digest__": np.frombuffer(
                model_digest(model).encode(), dtype=np.uint8)}
    for i, ml in enumerate(luts):
        for key, lut in [*((f"h{h}", bl) for h, bl in ml.heads.items()),
                         ("convf", ml.convf)]:
            table = _table(lut).cpu().numpy().astype(np.float32)
            arrs[f"b{i}_{key}_table"] = table
            packed = _jax_packed(lut, table)
            if packed is not None:
                arrs[f"b{i}_{key}_packed"] = packed
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrs)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _block_lut(table: np.ndarray, cfg, device) -> BlockLUT:
    t = torch.from_numpy(np.ascontiguousarray(table.T)).to(device)
    nonconstant = int((t != t[:1]).any(0).sum())
    pack = pack_float_table if cfg.last else pack_bit_table
    return BlockLUT(cfg=cfg, packed=pack(t, cfg.groupsici),
                    nonconstant=nonconstant)


def load_luts(path: str, model) -> list[MultiHeadLUT]:
    """Rebuild the LUTs of ``model`` (a ``ttnet_imagenet`` port model) from
    a ``save_luts`` archive of either package, on the model's device.
    Refuses (``ValueError``) an archive of another format version or one
    whose stored digest is not ``model``'s: its tables were enumerated
    from other weights."""
    with np.load(path) as data:
        ver = data.get("__format_version__")
        ver = None if ver is None else int(ver)
        if ver != LUT_FORMAT_VERSION:
            raise ValueError(
                f"LUT archive {path} has format version {ver}, this "
                f"compiler writes {LUT_FORMAT_VERSION}; the packing layout "
                "may differ — delete the archive to recompile.")
        stored = data.get("__params_digest__")
        want = model_digest(model)
        if stored is None:
            warnings.warn(f"LUT archive {path} predates weight digests; "
                          "cannot verify it matches the current weights",
                          stacklevel=2)
        elif bytes(stored.tobytes()).decode() != want:
            raise ValueError(
                f"LUT archive {path} was compiled from DIFFERENT weights "
                f"(stored digest {bytes(stored.tobytes()).decode()[:12]}… "
                f"!= current {want[:12]}…). Compiled tables are "
                "bit-faithful to their source weights; delete the archive "
                "or pass a fresh --lut_path to recompile.")
        device = model.stem_conv.weight.device
        luts = []
        for i, bcfg in enumerate(model.cfg.block_configs()):
            heads = {h: _block_lut(data[f"b{i}_h{h}_table"], hcfg, device)
                     for h, hcfg in bcfg.head_cfgs().items()}
            convf = _block_lut(data[f"b{i}_convf_table"], bcfg.convf_cfg(),
                               device)
            luts.append(MultiHeadLUT(cfg=bcfg, heads=heads, convf=convf))
    return luts
