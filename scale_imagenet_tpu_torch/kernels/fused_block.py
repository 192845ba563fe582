"""Fused pointwise TT-block: an eval-mode k=1 stride-1 Block_TT as one
kernel.

Counterpart of ``scale_imagenet_tpu/pallas/fused_block.py``.  One CUDA
kernel written for Hopper (``csrc/fused_block.cu``, whose header says what
bounds it on the card and how the design meets it) replaces both TPU
kernels, ``_kernel`` (``fused_block.py:41``) and ``_kernel_v2``
(``fused_block.py:191``): they compute one function, per pixel and group

    y = act(A2(W2_g @ gelu(A1(W1_g @ x_g))))

with the BNs folded into the affines ``A`` (``block_tt_pointwise_params``),
the GELU through the polynomial ``ops.gelu.fast_erf``, and act the
Heaviside (ReLU for a last block); f32 compute, stored in x's dtype.

Contract of ``fused_pointwise_block`` and ``fused_pointwise_block_v2``
(one function under both names, as the two JAX wrappers share one
contract)::

    x (N, G*ci), w1 (G, ci, m), s1/b1 (G, m), w2 (G, m, co), s2/b2 (G, co)
    -> (N, G*co)

``fused_block_tt_pointwise(_v2)`` take and return NHWC; the model's
``block_tt`` calls ``fused_pointwise_nchw`` on its NCHW activations.  Both
take the parameters a ``BlockTT`` folded once (``pointwise_params``), so a
forward adds no launch around the kernel's.  All
of them launch the one kernel, which reads and writes through strides, so
no transpose surrounds it.  The TPU wrappers' ``_bundle_size`` and
``_block_diag`` (groups bundled block-diagonally to fill 128 lanes) are
lane-alignment devices of the TPU and are not ported: the CUDA kernel
gives each group its own grid row.

Each entry point sends a CPU tensor to the plain PyTorch version beside it
and a CUDA tensor to the kernel, and counts the kernel launches in
``fused_pointwise_block.launches``.  There is no fallback from the card to
the plain version: a shape the kernel does not cover raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.binarize import heaviside01
from ..ops.gelu import fast_gelu

#: the (ci, co) pairs the kernel is instantiated for: every k=1 block of
#: the ttnet_imagenet variants and of the TT_FHE family (ci and co in
#: {1, .., 16}), and v2's (ci = 32, co 16 or 32)
SUPPORTED_CI = (1, 2, 4, 8, 16, 32)
SUPPORTED_CO = (1, 2, 4, 8, 16, 32)
SUPPORTED_PAIRS = frozenset(
    [(ci, co) for ci in SUPPORTED_CI[:-1] for co in SUPPORTED_CO[:-1]]
    + [(32, 16), (32, 32)])
ACTS = ("heaviside", "relu")

_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        fused_pointwise_block.launches = 0


def _count() -> None:
    with _count_lock:
        fused_pointwise_block.launches += 1


# ------------------------------------------------------------ parameters

def _affine(bn, conv_bias) -> tuple:
    """An eval BN after a conv as float32 ``(scale, bias)``, folded in the
    module's dtype or float32, whichever is wider (a bf16 module folds in
    float32): ``bn(conv(x) + cb) = s * conv(x) + (b + s * cb)``."""
    dt = torch.promote_types(bn.weight.dtype, torch.float32)
    w, b, mean, var = (getattr(bn, k).detach().to(dt) for k in
                       ("weight", "bias", "running_mean", "running_var"))
    s = w / torch.sqrt(var + bn.eps)          # ``layers.norm.bn_scale_bias``
    b = b - mean * s
    if conv_bias is not None:
        b = b + s * conv_bias.detach().to(dt)
    return s.float(), b.float()


def block_tt_pointwise_params(block) -> tuple:
    """Fold a k=1 ``BlockTT``'s weights and eval BNs into the kernel
    layout ``(w1 (G, ci, m), s1 (G, m), b1, w2 (G, m, co), s2 (G, co),
    b2)``, float32 (``fused_block.py:118``), from the module's values in
    float32 also when it is bf16 (``--bf16``).  A conv bias (present after
    ``--fold_bn``) goes into its affine's bias; the JAX package's fold
    drops it (``ROADMAP.md`` queue C).  Grouped conv output channels are
    group-major: channel ``g*m + j`` of conv1 is ``w1[g, :, j]``.
    ``w1`` is a ``(G, ci, m)`` view of a copy of conv1's ``(G, m, ci)``
    weight, the layout the kernel reads, so a launch copies nothing; the
    other five are contiguous."""
    cfg = block.cfg
    g = cfg.groupsici
    ci = cfg.in_planes // g
    m = cfg.t * cfg.in_planes // g
    co = cfg.out_planes // g
    w1 = block.conv1.weight.detach().float().reshape(g, m, ci).clone()
    w2 = block.conv2.weight.detach().float().reshape(g, co, m).transpose(1, 2)
    s1, b1 = _affine(block.bn1, block.conv1.bias)
    s2, b2 = _affine(block.bn2, block.conv2.bias)
    rest = [t.contiguous() for t in
            (s1.reshape(g, m), b1.reshape(g, m), w2, s2.reshape(g, co),
             b2.reshape(g, co))]
    return (w1.transpose(1, 2), *rest)


def _act(block) -> str:
    return "relu" if block.cfg.last else "heaviside"


def _check(x: torch.Tensor, params: tuple, act: str, channels: int):
    w1, s1, b1, w2, s2, b2 = params
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if w1.dim() != 3 or w2.dim() != 3:
        raise ValueError("w1 must be (G, ci, m) and w2 (G, m, co)")
    g, ci, m = w1.shape
    if w2.shape[:2] != (g, m):
        raise ValueError(f"w2 {tuple(w2.shape)} does not follow w1 "
                         f"{tuple(w1.shape)}")
    co = w2.shape[2]
    if (tuple(s1.shape), tuple(b1.shape), tuple(s2.shape),
            tuple(b2.shape)) != ((g, m), (g, m), (g, co), (g, co)):
        raise ValueError("affines must be (G, m), (G, m), (G, co), (G, co)")
    if channels != g * ci:
        raise ValueError(f"x has {channels} channels, the weights "
                         f"G*ci = {g * ci}")
    # the plain version holds the kernel's contract too: no shape runs on
    # the CPU that the card would refuse
    if (ci, co) not in SUPPORTED_PAIRS:
        raise ValueError(f"the fused kernel covers ci and co in "
                         f"{SUPPORTED_CI[:-1]}, and ci = 32 with co 16 or "
                         f"32, not ci={ci} co={co}")
    if any(t.device != x.device for t in params):
        raise ValueError(f"x on {x.device}, weights on "
                         f"{[str(t.device) for t in params]}")
    return g, ci, m, co


# ------------------------------------------------------- plain versions

def fused_pointwise_preact_plain(x, w1, s1, b1, w2, s2, b2) \
        -> torch.Tensor:
    """The plain version's f32 value before the activation, ``(N,
    G*co)``: where a Heaviside bit of the kernel and the plain version
    differ, this says how close to the threshold it was."""
    g, ci, m = w1.shape
    w1, s1, b1, w2, s2, b2 = (t.float() for t in (w1, s1, b1, w2, s2, b2))
    n = x.shape[0]
    xg = x.float().reshape(n, g, ci).transpose(0, 1)       # (G, N, ci)
    h = torch.bmm(xg, w1) * s1.unsqueeze(1) + b1.unsqueeze(1)
    y = torch.bmm(fast_gelu(h), w2) * s2.unsqueeze(1) + b2.unsqueeze(1)
    return y.transpose(0, 1).reshape(n, -1)


def fused_pointwise_block_plain(x, w1, s1, b1, w2, s2, b2,
                                act: str = "heaviside") -> torch.Tensor:
    """The fused block in plain PyTorch (any device): same contract,
    x ``(N, G*ci)`` -> ``(N, G*co)``, f32 compute, stored in x's dtype."""
    params = (w1, s1, b1, w2, s2, b2)
    _check(x, params, act, x.shape[1])
    y = fused_pointwise_preact_plain(x, *params)
    y = torch.relu(y) if act == "relu" else heaviside01(y)
    return y.to(x.dtype)


#: the v2 (bundled) TPU kernel computes the same function
fused_pointwise_block_v2_plain = fused_pointwise_block_plain


# ---------------------------------------------------------------- kernel

_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            from .build import load_library

            lib = load_library("fused_block")
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.fused_pointwise_launch.argtypes = (
                [p] * 8 + [ll] * 11 + [i] * 6 + [p])
            lib.fused_pointwise_launch.restype = i
            _lib = lib
    return _lib


def _launch(x4: torch.Tensor, params: tuple, act: str,
            out4: torch.Tensor) -> None:
    """Run the kernel on ``x4`` viewed as ``(B, G*ci, H, W)`` (any
    strides) into ``out4`` ``(B, G*co, H, W)`` (any strides)."""
    g, ci, m, co = _check(x4, params, act, x4.shape[1])
    if x4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x4.dtype}")
    w1, s1, b1, w2, s2, b2 = params
    if any(t.dtype != torch.float32 for t in params) or \
            not all(t.is_contiguous() for t in params[1:]):
        raise TypeError("weights and affines must be float32, all but w1 "
                        "contiguous (block_tt_pointwise_params)")
    # the kernel reads W1 as (G, m, ci) rows: the model's folded w1 is a
    # view of them (no copy here); another layout is copied
    w1t = w1.transpose(1, 2).contiguous()
    b, _, h, w = x4.shape
    lib = _library()
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream(x4.device).cuda_stream
        err = lib.fused_pointwise_launch(
            x4.data_ptr(), out4.data_ptr(), w1t.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            b * h * w, h * w, w, *x4.stride(), *out4.stride(), g, ci, m, co,
            int(x4.dtype == torch.bfloat16), int(act == "relu"), stream)
    if err:
        raise RuntimeError(f"fused_pointwise_block launch failed: CUDA "
                           f"error {err}")
    _count()


def fused_pointwise_block(x, w1, s1, b1, w2, s2, b2,
                          act: str = "heaviside") -> torch.Tensor:
    """x ``(N, G*ci)`` -> ``(N, G*co)``: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    params = (w1, s1, b1, w2, s2, b2)
    if x.device.type == "cpu":
        return fused_pointwise_block_plain(x, *params, act=act)
    if x.dim() != 2:
        raise ValueError(f"x must be (N, G*ci), got {tuple(x.shape)}")
    n = x.shape[0]
    out = torch.empty((n, w2.shape[0] * w2.shape[2]), dtype=x.dtype,
                      device=x.device)
    # rows as (B=1, C, H=N, W=1): pixel n at row stride, channel at 1
    _launch(x.t().unsqueeze(0).unsqueeze(-1), params, act,
            out.t().unsqueeze(0).unsqueeze(-1))
    return out


#: ``fused_block.py:205``: the same contract, the same kernel
fused_pointwise_block_v2 = fused_pointwise_block


def fused_pointwise_nchw(x: torch.Tensor, params: tuple,
                         act: str) -> torch.Tensor:
    """NCHW ``(B, G*ci, H, W)`` (any strides) -> contiguous NCHW
    ``(B, G*co, H, W)``: the kernel reads across pixels with no transpose
    on the card; the CPU goes through the plain row version."""
    b, c, h, w = x.shape
    w2 = params[3]
    if x.device.type == "cpu":
        rows = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
        y = fused_pointwise_block_plain(rows, *params, act=act)
        return y.reshape(b, h, w, -1).permute(0, 3, 1, 2).contiguous()
    out = torch.empty((b, w2.shape[0] * w2.shape[2], h, w), dtype=x.dtype,
                      device=x.device)
    _launch(x, params, act, out)
    return out


def _check_pointwise(cfg) -> None:
    if not (cfg.k in (1, (1, 1)) and cfg.stride == 1 and cfg.padding == 0):
        raise ValueError(f"the fused block is a k=1 stride-1 unpadded "
                         f"Block_TT, not {cfg}")


def fused_block_tt_pointwise(block, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode replacement for a k=1 stride-1 ``block_tt`` on NHWC
    ``x``; returns NHWC (``fused_block.py:145``)."""
    _check_pointwise(block.cfg)
    b, h, w, c = x.shape
    y = fused_pointwise_block(x.reshape(b * h * w, c),
                              *block.pointwise_params(), act=_act(block))
    return y.reshape(b, h, w, block.cfg.out_planes)


#: ``fused_block.py:264``: the same function
fused_block_tt_pointwise_v2 = fused_block_tt_pointwise

fused_pointwise_block.launches = 0


__all__ = ["block_tt_pointwise_params", "fused_pointwise_block",
           "fused_pointwise_block_v2", "fused_pointwise_block_plain",
           "fused_pointwise_preact_plain",
           "fused_pointwise_block_v2_plain", "fused_pointwise_nchw",
           "fused_block_tt_pointwise", "fused_block_tt_pointwise_v2",
           "reset_launches", "SUPPORTED_CI", "SUPPORTED_CO",
           "SUPPORTED_PAIRS"]
