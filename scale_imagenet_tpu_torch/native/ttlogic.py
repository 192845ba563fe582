"""ctypes binding of the native logic engine ``native/ttlogic.cpp`` (the
port's own counterpart of ``scale_imagenet_tpu/native/ttlogic.py:23-333``).

The repo-root source is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/native/`` at the repo root (a directory
``.gitignore`` lists).  The file name carries a hash of the source and the
flags, as ``kernels/build.py`` does for the CUDA sources, so an edited
source rebuilds and an unchanged one loads.  Nothing builds at import time.

There is no Python or sympy fallback: a failed build raises with the
compiler's error, and a call the engine refuses (it returns -1) raises.
The engine keeps no global state, and ctypes releases the interpreter lock
around each call, so the per-filter minimizations of a block can run on a
thread pool (``compile/gate_net.py``).

Cube convention: a cube is ``(value, mask)``; mask bit b = 1 is a
don't-care, and pattern bit b is the truth-table index bit b, i.e. the
reference's variable ``x_{n-1-b}`` (MSB-first enumeration).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "ttlogic.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libttlogic-{digest[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build never tears it


def _library() -> ctypes.CDLL:
    """Build (if needed) and load the engine, with every argument type
    declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        i, lg = ctypes.c_int, ctypes.c_long
        lib.ttlogic_minimize.restype = i
        lib.ttlogic_minimize.argtypes = [i, _u32p, i, _u32p, i]
        lib.ttlogic_eval_packed.restype = None
        lib.ttlogic_eval_packed.argtypes = [_u8p, _u32p, i, _u8p]
        lib.ttlogic_pack_bits.restype = None
        lib.ttlogic_pack_bits.argtypes = [_u8p, i, _u8p]
        lib.ttlogic_count_gates.restype = lg
        lib.ttlogic_count_gates.argtypes = [_u32p, i, i]
        lib.ttlogic_expand_cover.restype = i
        lib.ttlogic_expand_cover.argtypes = [i, _u8p, _u32p, i]
        lib.ttlogic_espresso.restype = i
        lib.ttlogic_espresso.argtypes = [i, _u8p, i, _u32p, i]
        lib.ttlogic_verify_cover.restype = lg
        lib.ttlogic_verify_cover.argtypes = [i, _u8p, _u32p, i]
        lib.ttlogic_eval_covers.restype = lg
        lib.ttlogic_eval_covers.argtypes = [i, lg, _u64p, _u32p, _i64p, i,
                                            _u64p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _pairs(out: np.ndarray, k: int, what: str, n: int) -> list:
    if k < 0:
        raise ValueError(f"ttlogic {what} refused n={n} (or its output "
                         "overflowed)")
    return [(int(out[2 * j]), int(out[2 * j + 1])) for j in range(k)]


def _terms_array(terms) -> np.ndarray:
    arr = np.zeros(2 * max(len(terms), 1), dtype=np.uint32)
    for j, (v, m) in enumerate(terms):
        arr[2 * j], arr[2 * j + 1] = v, m
    return arr


def minimize_terms(minterms, n: int) -> list[tuple[int, int]]:
    """Quine-McCluskey primes + greedy cover of a minterm list -> ``(value,
    mask)`` cubes."""
    arr = np.ascontiguousarray(list(minterms), dtype=np.uint32)
    max_terms = max(len(arr), 16)
    out = np.zeros(2 * max_terms, dtype=np.uint32)
    k = _library().ttlogic_minimize(n, _ptr(arr, _u32p), len(arr),
                                    _ptr(out, _u32p), max_terms)
    return _pairs(out, k, "minimize", n)


def terms_to_dnf(terms, n: int) -> str:
    """(value, mask) cubes -> sympy-style DNF string over x_0..x_{n-1}."""
    if not terms:
        return "False"
    parts = []
    for value, mask in terms:
        lits = []
        for i in range(n):
            bit = n - 1 - i             # x_i corresponds to pattern bit
            if (mask >> bit) & 1:
                continue
            lits.append(("" if (value >> bit) & 1 else "~") + f"x_{i}")
        parts.append("(" + " & ".join(lits) + ")" if len(lits) > 1
                     else (lits[0] if lits else "True"))
    return " | ".join(parts)


def pack_table_bits(column) -> np.ndarray:
    """0/1 column -> packed uint8 bits (little-endian in each byte)."""
    vals = np.ascontiguousarray((np.asarray(column) != 0).astype(np.uint8))
    out = np.zeros((len(vals) + 7) // 8, dtype=np.uint8)
    _library().ttlogic_pack_bits(_ptr(vals, _u8p), len(vals),
                                 _ptr(out, _u8p))
    return out


def eval_packed_table(packed: np.ndarray, indices) -> np.ndarray:
    """Entries ``indices`` of a packed table, as uint8 0/1."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.uint32))
    out = np.zeros(len(idx), dtype=np.uint8)
    _library().ttlogic_eval_packed(_ptr(packed, _u8p), _ptr(idx, _u32p),
                                   len(idx), _ptr(out, _u8p))
    return out


def expand_cover(packed: np.ndarray, n: int) -> list[tuple[int, int]]:
    """Espresso-style expand-and-cover over a packed 2^n-bit table."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    max_terms = 1 << min(n, 20)
    out = np.zeros(2 * max_terms, dtype=np.uint32)
    k = _library().ttlogic_expand_cover(n, _ptr(packed, _u8p),
                                        _ptr(out, _u32p), max_terms)
    return _pairs(out, k, "expand_cover", n)


def espresso_cover(packed: np.ndarray, n: int,
                   iters: int = 2) -> list[tuple[int, int]]:
    """Expand-and-cover, then ``iters`` REDUCE -> EXPAND -> IRREDUNDANT
    iterations; every intermediate cover stays exact."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    max_terms = 1 << min(n, 20)
    out = np.zeros(2 * max_terms, dtype=np.uint32)
    k = _library().ttlogic_espresso(n, _ptr(packed, _u8p), int(iters),
                                    _ptr(out, _u32p), max_terms)
    return _pairs(out, k, "espresso", n)


def verify_cover(packed: np.ndarray, terms, n: int) -> int:
    """Number of minterms where the DNF ``terms`` disagrees with the packed
    table (0 = exact)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    arr = _terms_array(terms)
    r = _library().ttlogic_verify_cover(n, _ptr(packed, _u8p),
                                        _ptr(arr, _u32p), len(terms))
    if r < 0:
        raise ValueError(f"ttlogic verify_cover refused n={n}")
    return int(r)


def eval_covers(planes: np.ndarray, covers: list, n: int) -> np.ndarray:
    """Bit-sliced gate-level evaluation of per-filter cube covers.

    ``planes``: (n, words) uint64, plane p = pattern bit p of 64 positions
    a word (position 64*w + i is bit i of word w).  ``covers``: one (T, 2)
    uint32 (value, mask) array per filter.  Returns (filters, words)
    uint64: each cover evaluated as word-parallel AND/OR/NOT."""
    planes = np.ascontiguousarray(planes, dtype=np.uint64)
    words = planes.shape[1]
    offsets = np.zeros(len(covers) + 1, dtype=np.int64)
    for j, c in enumerate(covers):
        offsets[j + 1] = offsets[j] + len(c)
    if offsets[-1]:
        flat = np.concatenate(
            [np.asarray(c, dtype=np.uint32).reshape(-1, 2) for c in covers
             if len(c)]).reshape(-1)
    else:
        flat = np.zeros(2, dtype=np.uint32)
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    out = np.zeros((len(covers), words), dtype=np.uint64)
    if words == 0:                # no position: the engine refuses 0 words
        return out
    rc = _library().ttlogic_eval_covers(
        n, words, _ptr(planes, _u64p), _ptr(flat, _u32p),
        _ptr(offsets, _i64p), len(covers), _ptr(out, _u64p))
    if rc < 0:
        raise ValueError(f"ttlogic eval_covers refused n={n}")
    return out


def count_term_gates(terms, n: int) -> int:
    """Gate count of a cube cover: ORs = terms - 1, ANDs = sum(literals -
    1), NOTs = negated literals (the meter of ``logic.count_gates``)."""
    arr = _terms_array(terms)
    return int(_library().ttlogic_count_gates(_ptr(arr, _u32p), len(terms),
                                              n))
