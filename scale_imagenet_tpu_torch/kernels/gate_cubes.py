"""Bit-sliced cube evaluation: a compiled Block_TT's covers evaluated over
32 window positions a word.

The JAX package has no Pallas kernel for this: its device evaluator
(``scale_imagenet_tpu/compile/gate_device.py::gate_block_apply_device``,
:195-221) is XLA ops over a ``(G, F, T, W)`` int32 mismatch tensor, which
XLA fuses on the TPU.  Run eagerly, that tensor is gigabytes a flagship
head, written and read once for each of the n bit planes, so the port
evaluates the covers in a CUDA kernel written for Hopper
(``csrc/gate_cubes.cu``; its header says what bounds it and how the design
meets it).

Contract of ``gate_cubes(planes, cubes, offsets, filters, invert)``::

    planes  (G, n, W) int32   bit-sliced window bits (gate_device.py:160)
    cubes   (T_total, 2) int32  (value, mask) of every filter's cover, the
                              G*F filters one after another (mask bit =
                              don't care; int32 holding the uint32 bits)
    offsets (G*F + 1,) int64  filter j's cubes are offsets[j]:offsets[j+1]
    -> (G, F, W) int32        OR over a filter's cubes of the AND of its
                              fixed literals; inverted under ``invert``
                              (CNF: the cubes are the complement's)

bit for bit the ``out_words`` of ``gate_block_apply_device`` (:205-215),
tail bits of the last word included.  A constant filter has an empty cover
and gives 0 (all ones inverted), as there; the caller substitutes the
constant after unpacking.

A CPU tensor goes to the plain PyTorch version beside it (the JAX op
sequence in int32, chunked over cubes so that its memory stays bounded); a
CUDA tensor goes to the kernel, and the launch is counted in
``gate_cubes.launches``.  There is no fallback from the card to the plain
version: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .build import check_device

#: the kernel's widest pattern (the cubes are uint32 words)
MAX_BITS = 32
#: bytes of the plain version's (G, F, chunk, W) intermediate
PLAIN_CHUNK_BYTES = 1 << 28

_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        gate_cubes.launches = 0


def _count() -> None:
    with _count_lock:
        gate_cubes.launches += 1


def _check(planes: torch.Tensor, cubes: torch.Tensor,
           offsets: torch.Tensor, filters: int) -> tuple:
    if planes.dim() != 3 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (G, n, W) int32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    g, n, _ = planes.shape
    if not 1 <= n <= MAX_BITS:
        raise ValueError(f"n={n} bits: the kernel takes 1..{MAX_BITS}")
    if cubes.dim() != 2 or cubes.shape[1] != 2 or cubes.dtype != torch.int32:
        raise ValueError(f"cubes must be (T, 2) int32, got "
                         f"{tuple(cubes.shape)} {cubes.dtype}")
    if filters < 1 or tuple(offsets.shape) != (g * filters + 1,) \
            or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be ({g * filters + 1},) int64 for "
                         f"G={g} groups of {filters} filters, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if cubes.device != planes.device or offsets.device != planes.device:
        raise ValueError(f"planes on {planes.device}, cubes on "
                         f"{cubes.device}, offsets on {offsets.device}")
    return g, n


def gate_cubes_plain(planes: torch.Tensor, cubes: torch.Tensor,
                     offsets: torch.Tensor, filters: int,
                     invert: bool = False) -> torch.Tensor:
    """The JAX op sequence (``gate_device.py:205-215``) in torch int32, any
    device: per chunk of cube slots, the padded ``(G, F, tc, n)`` xor and
    fixed-mask constants, the mismatch OR-ed over the n planes, the cubes
    OR-ed together; a chunk's mismatch takes at most
    ``PLAIN_CHUNK_BYTES``."""
    g, n = _check(planes, cubes, offsets, filters)
    w = planes.shape[2]
    dev = planes.device
    counts = offsets[1:] - offsets[:-1]                     # (G*F,)
    t_max = int(counts.max()) if counts.numel() else 0
    out = torch.zeros((g, filters, w), dtype=torch.int32, device=dev)
    tc = max(1, min(t_max,
                    PLAIN_CHUNK_BYTES // max(1, g * filters * w * 4)))
    bit = torch.arange(n, device=dev, dtype=torch.int32)
    for t0 in range(0, t_max, tc):
        slot = t0 + torch.arange(min(tc, t_max - t0), device=dev)
        valid = slot[None, :] < counts[:, None]             # (G*F, tc)
        idx = (offsets[:-1, None] + slot[None, :]).clamp(
            max=max(cubes.shape[0] - 1, 0))
        cube = cubes[idx] if cubes.shape[0] else torch.zeros(
            (*idx.shape, 2), dtype=torch.int32, device=dev)
        value, mask = cube[..., 0:1], cube[..., 1:2]
        # -1 where the literal is positive / the bit is fixed (JAX's
        # e_const and c_const), (G, F, tc, n)
        e = (-((value >> bit) & 1)).view(g, filters, -1, n)
        c = (-((~mask >> bit) & 1)).view(g, filters, -1, n)
        mism = torch.zeros((g, filters, slot.numel(), w), dtype=torch.int32,
                           device=dev)
        for p in range(n):
            mism |= (planes[:, None, None, p, :] ^ e[..., p, None]) \
                & c[..., p, None]
        cube_words = ~mism & (-valid.to(torch.int32)).view(g, filters, -1, 1)
        while cube_words.shape[2] > 1:                      # OR over cubes
            if cube_words.shape[2] % 2:
                cube_words = torch.nn.functional.pad(cube_words,
                                                     (0, 0, 0, 1))
            cube_words = cube_words[:, :, 0::2] | cube_words[:, :, 1::2]
        out |= cube_words[:, :, 0]
    return ~out if invert else out


# ---------------------------------------------------------------- kernel

_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            from .build import load_library

            lib = load_library("gate_cubes")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.gate_cubes_launch.argtypes = [p, p, p, p, i, i, i,
                                              ctypes.c_longlong, i, p]
            lib.gate_cubes_launch.restype = i
            lib.gate_cubes_segments.argtypes = [i, ctypes.c_longlong]
            lib.gate_cubes_segments.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def gate_cubes(planes: torch.Tensor, cubes: torch.Tensor,
               offsets: torch.Tensor, filters: int,
               invert: bool = False) -> torch.Tensor:
    """The cube evaluation: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns ``(G, F, W)`` int32."""
    if planes.device.type == "cpu":
        return gate_cubes_plain(planes, cubes, offsets, filters, invert)
    g, n = _check(planes, cubes, offsets, filters)
    if not (planes.is_contiguous() and cubes.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("the kernel reads contiguous planes, cubes and "
                         "offsets")
    if cubes.data_ptr() % 8:
        raise ValueError("the kernel reads (value, mask) pairs as 8-byte "
                         "vectors: cubes must be 8-byte aligned")
    w = planes.shape[2]
    out = torch.empty((g, filters, w), dtype=torch.int32,
                      device=planes.device)
    lib = _library()
    check_device(planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.gate_cubes_launch(planes.data_ptr(), cubes.data_ptr(),
                                    offsets.data_ptr(), out.data_ptr(), g,
                                    filters, n, w, int(invert), stream)
    if err:
        raise RuntimeError(f"gate_cubes launch failed: CUDA error {err}")
    _count()
    return out


gate_cubes.launches = 0


def segments(n: int, words: int) -> int:
    """The number S of equal runs the kernel cuts the flat cube array into
    at a launch of ``n`` bits and ``words`` words on the current card: run
    s holds cubes ``[T*s // S, T*(s+1) // S)`` of the T in ``cubes``.  The
    card tests place covers on run boundaries with it."""
    if not 1 <= n <= MAX_BITS or words < 1:
        raise ValueError(f"n={n}, words={words}")
    return int(_library().gate_cubes_segments(n, words))


__all__ = ["MAX_BITS", "gate_cubes", "gate_cubes_plain", "reset_launches",
           "segments"]
