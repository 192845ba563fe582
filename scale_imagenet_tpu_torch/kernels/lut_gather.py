"""LUT window gathers: a compiled Block_TT served as its truth tables.

Counterpart of ``scale_imagenet_tpu/pallas/lut_gather.py`` together with the
index conv that feeds it in ``scale_imagenet_tpu/compile/lut_eval.py``.  Two
CUDA kernels written for Hopper (``csrc/lut_gather.cu``, whose header says
what bounds them on the card and how the design meets it):

* ``lut_window_bits`` replaces ``_bit_kernel`` (``lut_gather.py:84``): every
  Heaviside head and fuse head of the compiled-LUT forward, K config-identical
  heads (the merged heads 1+2) in one launch;
* ``lut_window_float`` replaces ``_float_kernel`` (``lut_gather.py:107``):
  the last block's float (ReLU) fuse head when it is served as its table.

Each takes the block's {0,1} input bits ``x`` (B, C, H, W), bf16 or f32, in
any strides (NCHW or channels-last), and builds every window's n-bit
pattern index itself: bit ``j = c*kh*kw + a*kw + b`` of group g's window at
``(ho, wo)`` is ``x[:, g*ci + c, ho*stride - padding + a, wo*stride -
padding + b]`` (0 outside the image, the constant pad), with weight
``2^(n-1-j)`` (MSB-first, channel-major, as ``enumerate_patterns`` orders
the table rows).  Contract, ``E = B*Ho*Wo`` windows in NHWC order::

    lut_window_bits(x, words (K*G, F, Wd) int32, k, stride, padding, heads=K)
        -> (E, K*G*F) in x's dtype; channel h*G*F + g*F + f is bit
           (idx & 31) of words[h*G + g, f, idx >> 5]
    lut_window_float(x, table (G, 2^n, F) f32, k, stride, padding)
        -> (E, G*F) f32; channel g*F + f is table[g, idx, f]

``(E, channels)`` is the NHWC activation layout, so no transpose surrounds
the kernels.  ``words`` is the JAX ``pack_bit_table`` layout ``(G, F, S,
128)`` flattened over ``(S, 128)``: the words are identical.  The float
table is filter-minor, so one lookup's F values are contiguous.

The plain versions compute the index as the index conv did (pad, f32
grouped conv with power-of-two weights, round, NHWC) and then gather with
``lut_gather_bits_plain`` / ``lut_gather_float_plain``, which keep the JAX
kernels' index-array contract.  Each wrapper sends a CPU tensor to its plain
version and a CUDA tensor to its kernel, and counts the kernel launches in
its ``launches`` attribute.  There is no fallback from the card to the
plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from .build import check_device

#: the widest window the kernels take (index bits), and the most windows
#: a launch (the kernels index them in 32 bits)
MAX_BITS = 24
MAX_WINDOWS = 2 ** 30

_count_lock = threading.Lock()


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def reset_launches() -> None:
    with _count_lock:
        lut_window_bits.launches = 0
        lut_window_float.launches = 0


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


# ---------------------------------------------------------------- packing

def pack_bit_table(table, groups: int) -> torch.Tensor:
    """Pack a {0,1} truth table ``(2^n, out)`` into ``(G, F, W)`` int32
    words: entry v at word ``v >> 5``, bit ``v & 31``; ``W`` is
    ``2^n / 32`` rounded up to a multiple of 128 (at least 128)."""
    table = torch.as_tensor(table)
    v, out = table.shape
    f = out // groups
    bits = table.T.reshape(groups, f, v)
    if not ((bits == 0) | (bits == 1)).all():
        raise ValueError("bit table expected; found non-binary entries")
    w = max(1, -(-v // 4096)) * 128
    bits = torch.nn.functional.pad(bits.to(torch.int64), (0, 32 * w - v))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(groups, f, w, 32) << shifts).sum(-1)
    # two's-complement wrap of the 32-bit word, as the JAX uint32 view
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).contiguous()


def pack_float_table(table, groups: int) -> torch.Tensor:
    """Arrange a float table ``(2^n, out)`` filter-minor as ``(G, 2^n, F)``
    float32: one lookup's F values are contiguous."""
    table = torch.as_tensor(table)
    v, out = table.shape
    return table.reshape(v, groups, out // groups).transpose(0, 1).to(
        torch.float32).contiguous()


# ---------------------------------------------------------------- checks

def _check(tab: torch.Tensor, idx: torch.Tensor, tab_dtype: torch.dtype):
    if tab.dtype != tab_dtype or tab.dim() != 3:
        raise TypeError(f"table must be 3-D {tab_dtype}, got "
                        f"{tuple(tab.shape)} {tab.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise TypeError(f"idx must be 2-D int32 (E, G), got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if idx.shape[1] != tab.shape[0]:
        raise ValueError(f"idx has {idx.shape[1]} groups, table "
                         f"{tab.shape[0]}")
    if tab.device != idx.device:
        raise ValueError(f"table on {tab.device}, idx on {idx.device}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")


def _check_range(idx: torch.Tensor, entries: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= entries):
        raise IndexError(f"lookup index outside [0, {entries})")


def window_out_size(h: int, w: int, k, stride: int, padding: int) -> tuple:
    """``(Ho, Wo)`` of a padded, strided window over an ``h x w`` image."""
    kh, kw = _pair(k)
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def _check_window(x: torch.Tensor, tab: torch.Tensor, tab_dtype, k,
                  stride: int, padding: int, heads: int) -> dict:
    """Check a window launch; returns its geometry."""
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be 4-D (B, C, H, W) bfloat16 or float32 "
                        f"bits, got {tuple(x.shape)} {x.dtype}")
    if tab.dtype != tab_dtype or tab.dim() != 3:
        raise TypeError(f"table must be 3-D {tab_dtype}, got "
                        f"{tuple(tab.shape)} {tab.dtype}")
    if tab.device != x.device:
        raise ValueError(f"x on {x.device}, table on {tab.device}")
    if not tab.is_contiguous():
        raise ValueError("table must be contiguous")
    if heads < 1 or tab.shape[0] % heads:
        raise ValueError(f"{tab.shape[0]} tables do not split into "
                         f"{heads} heads")
    kh, kw = _pair(k)
    g = tab.shape[0] // heads
    b, c, h, w = x.shape
    if c % g:
        raise ValueError(f"x has {c} channels, not a multiple of the "
                         f"{g} groups")
    ci = c // g
    n = kh * kw * ci
    if not 1 <= n <= MAX_BITS:
        raise ValueError(f"a window of {n} bits: the kernels take 1 to "
                         f"{MAX_BITS}")
    if tab_dtype == torch.int32:
        if 32 * tab.shape[2] < 2 ** n:
            raise ValueError(f"{tab.shape[2]} words a table do not hold "
                             f"2^{n} entries")
        f = tab.shape[1]
    else:
        if tab.shape[1] != 2 ** n:
            raise ValueError(f"float table has {tab.shape[1]} entries, the "
                             f"window 2^{n}")
        f = tab.shape[2]
    ho, wo = window_out_size(h, w, (kh, kw), stride, padding)
    if stride < 1 or padding < 0 or ho < 1 or wo < 1:
        raise ValueError(f"no window of {kh}x{kw}, stride {stride}, "
                         f"padding {padding} fits a {h}x{w} image")
    if b * ho * wo >= MAX_WINDOWS:
        raise ValueError(f"{b * ho * wo} windows: a launch takes fewer than "
                         f"{MAX_WINDOWS}")
    return dict(b=b, h=h, w=w, ho=ho, wo=wo, kh=kh, kw=kw, ci=ci, g=g, f=f)


# ---------------------------------------------------------- plain versions

def index_weights(kh: int, kw: int, ci: int, groups: int,
                  device="cpu") -> torch.Tensor:
    """Grouped-conv weights computing the pattern index: bit j (MSB-first,
    channel-major (c, a, b)) has weight 2^(n-1-j).  OIHW ``(G, ci, kh, kw)``
    float32."""
    n = kh * kw * ci
    powers = 2.0 ** torch.arange(n - 1, -1, -1, dtype=torch.float64)
    w = powers.reshape(1, ci, kh, kw).expand(groups, ci, kh, kw)
    return w.to(device=device, dtype=torch.float32).contiguous()


def window_index_plain(x: torch.Tensor, groups: int, k, stride: int,
                       padding: int) -> torch.Tensor:
    """Pattern index of every window, ``(E, G)`` int32 in NHWC order: pad,
    grouped conv with power-of-two weights, round.  The conv runs in
    float32 whatever the bit dtype: a bf16 conv would return bf16, which
    rounds integers above 256; float32 holds the index exactly up to
    2^24."""
    kh, kw = _pair(k)
    if padding:
        x = F.pad(x, (padding,) * 4)
    idx = F.conv2d(x.float(), index_weights(kh, kw, x.shape[1] // groups,
                                            groups, x.device),
                   stride=stride, groups=groups)        # (B, G, Ho, Wo)
    # round, not truncate: exact sums are integers either way
    return idx.round().to(torch.int32).permute(0, 2, 3, 1).reshape(
        -1, groups).contiguous()


def lut_gather_bits_plain(words: torch.Tensor, idx: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) \
        -> torch.Tensor:
    """The JAX bit kernel's contract in plain PyTorch (any device):
    ``(E, G)`` indices into ``(G, F, W)`` words -> ``(E, G*F)``."""
    _check(words, idx, torch.int32)
    g, f, w = words.shape
    _check_range(idx, 32 * w)
    offs = (torch.arange(g * f, device=words.device, dtype=torch.int64)
            * w).view(g, f)
    vals = torch.take(words, (idx.to(torch.int64) >> 5).unsqueeze(-1) + offs)
    bits = (vals >> (idx & 31).unsqueeze(-1)) & 1         # (E, G, F)
    return bits.reshape(idx.shape[0], g * f).to(out_dtype)


def lut_gather_float_plain(table: torch.Tensor, idx: torch.Tensor) \
        -> torch.Tensor:
    """The JAX float kernel's contract in plain PyTorch (any device):
    ``(E, G)`` indices into ``(G, V, F)`` tables -> ``(E, G*F)`` f32."""
    _check(table, idx, torch.float32)
    g, v, f = table.shape
    _check_range(idx, v)
    rows = idx.to(torch.int64) + torch.arange(
        g, device=table.device, dtype=torch.int64) * v        # (E, G)
    return table.reshape(g * v, f)[rows].reshape(idx.shape[0], g * f)


def lut_window_bits_plain(x_bits: torch.Tensor, words: torch.Tensor, k,
                          stride: int = 1, padding: int = 0,
                          heads: int = 1) -> torch.Tensor:
    """``lut_window_bits`` in plain PyTorch (any device)."""
    geo = _check_window(x_bits, words, torch.int32, k, stride, padding,
                        heads)
    idx = window_index_plain(x_bits, geo["g"], k, stride, padding)
    return lut_gather_bits_plain(words, idx.repeat(1, heads), x_bits.dtype)


def lut_window_float_plain(x: torch.Tensor, table: torch.Tensor, k,
                           stride: int = 1, padding: int = 0) \
        -> torch.Tensor:
    """``lut_window_float`` in plain PyTorch (any device)."""
    geo = _check_window(x, table, torch.float32, k, stride, padding, 1)
    return lut_gather_float_plain(
        table, window_index_plain(x, geo["g"], k, stride, padding))


# ---------------------------------------------------------------- kernels

_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            from .build import load_library

            lib = load_library("lut_gather")
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.lut_window_bits_launch.argtypes = (
                [p] * 3 + [i] * 3 + [ll] * 4 + [i] * 12 + [p])
            lib.lut_window_bits_launch.restype = i
            lib.lut_window_float_launch.argtypes = (
                [p] * 3 + [i] * 3 + [ll] * 4 + [i] * 10 + [p])
            lib.lut_window_float_launch.restype = i
            _lib = lib
    return _lib


def _launch(name: str, x: torch.Tensor, tab: torch.Tensor, out: torch.Tensor,
            geo: dict, stride: int, padding: int, *extra: int) -> None:
    lib = _library()
    check_device(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            x.data_ptr(), tab.data_ptr(), out.data_ptr(), geo["b"], geo["h"],
            geo["w"], *x.stride(), geo["ho"], geo["wo"], geo["kh"],
            geo["kw"], stride, padding, geo["ci"], geo["g"], geo["f"],
            *extra, int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def lut_window_bits(x_bits: torch.Tensor, words: torch.Tensor, k,
                    stride: int = 1, padding: int = 0,
                    heads: int = 1) -> torch.Tensor:
    """The window bit gather: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns ``(E, heads*G*F)`` in x's dtype."""
    if x_bits.device.type == "cpu":
        return lut_window_bits_plain(x_bits, words, k, stride, padding,
                                     heads)
    geo = _check_window(x_bits, words, torch.int32, k, stride, padding,
                        heads)
    out = torch.empty((geo["b"] * geo["ho"] * geo["wo"],
                       words.shape[0] * geo["f"]), dtype=x_bits.dtype,
                      device=x_bits.device)
    _launch("lut_window_bits", x_bits, words, out, geo, stride, padding,
            words.shape[2], heads)
    _count(lut_window_bits)
    return out


def lut_window_float(x: torch.Tensor, table: torch.Tensor, k,
                     stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The window float gather: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns ``(E, G*F)`` float32."""
    if x.device.type == "cpu":
        return lut_window_float_plain(x, table, k, stride, padding)
    geo = _check_window(x, table, torch.float32, k, stride, padding, 1)
    if table.data_ptr() % 16:
        raise ValueError("the kernel reads the float table in 16-byte "
                         "vectors: its data must be 16-byte aligned")
    out = torch.empty((geo["b"] * geo["ho"] * geo["wo"],
                       geo["g"] * geo["f"]), dtype=torch.float32,
                      device=x.device)
    _launch("lut_window_float", x, table, out, geo, stride, padding)
    _count(lut_window_float)
    return out


lut_window_bits.launches = 0
lut_window_float.launches = 0


__all__ = ["MAX_BITS", "pack_bit_table", "pack_float_table", "index_weights",
           "window_out_size", "window_index_plain", "lut_gather_bits_plain",
           "lut_gather_float_plain", "lut_window_bits",
           "lut_window_bits_plain", "lut_window_float",
           "lut_window_float_plain", "reset_launches"]
