"""Peaks of the card and the work of the kernels and models, from shapes.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).  The
port keeps float32 off the tensor cores (TF32 off), so a float32 model's
share of the peak is taken against the 67 TFLOP/s float32 rate.
"""

from __future__ import annotations

import torch
from torch import nn

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
GIB = 2.0 ** 30


def model_flops(model: nn.Module, image_size: int) -> int:
    """Float operations of one forward image: 2 x the multiply-adds of
    every conv and linear layer, from the shapes of a meta-device forward
    of the plain reference (``model`` on the meta device)."""
    total = 0

    def hook(mod, inp, out):
        nonlocal total
        w = mod.weight
        if isinstance(mod, nn.Conv2d):
            total += 2 * out.numel() * w[0].numel()
        else:
            total += 2 * out.numel() * w.shape[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.device("meta"), torch.no_grad():
            model.eval()(torch.zeros(1, 3, image_size, image_size))
    finally:
        for h in handles:
            h.remove()
    return total


def table_words(n: int) -> int:
    """32-bit words a filter's table of 2^n bits takes in the window
    kernel's layout: rounded up to a multiple of 128 words."""
    return max(128, -(-(2 ** n // 32) // 128) * 128)


def window_launches(model: nn.Module, batch: int, image_size: int,
                    bits_bytes: int = 2) -> list:
    """The ``lut_window_bits`` launches of one batch of the compiled-table
    forward: every Block_TT head of a multi-head block but the last
    block's float fuse head, the two k x k heads of a block sharing one
    launch.  Each launch: ``{"bytes", "ops"}`` of the table contract:
    the input bits and the output read or written once, every table word
    once; ``2 n`` operations a window and group to build the index and 2
    an output.  Shapes come from a forward of the reference on the meta
    device (``model`` there), whose Block_TT modules carry ``conv1`` and
    ``last``."""
    seen = []

    def hook(mod, inp):
        if not mod.last:
            seen.append((mod, tuple(inp[0].shape)))

    blocks = [m for m in model.modules() if type(m).__name__ == "BlockTT"]
    handles = [m.register_forward_pre_hook(hook) for m in blocks]
    try:
        with torch.device("meta"), torch.no_grad():
            model.eval()(torch.zeros(batch, 3, image_size, image_size))
    finally:
        for h in handles:
            h.remove()
    launches, i = [], 0
    while i < len(seen):
        mod, (b, c, h, w) = seen[i]
        conv = mod.conv1
        heads = 1
        # heads 1 and 2 of a block: one launch on both tables
        if i + 1 < len(seen) and seen[i + 1][1] == seen[i][1] and \
                seen[i + 1][0].conv1.weight.shape == conv.weight.shape \
                and seen[i + 1][0].conv1.stride == conv.stride:
            heads = 2
        kh, kw = conv.kernel_size
        sh = conv.stride[0]
        pad = mod.padding
        g = conv.groups
        f = mod.conv2.out_channels // g
        n = kh * kw * (c // g)
        ho = (h + 2 * pad - kh) // sh + 1
        wo = (w + 2 * pad - kw) // sh + 1
        e = b * ho * wo
        out = e * heads * g * f
        nbytes = (b * c * h * w + out) * bits_bytes \
            + heads * g * f * table_words(n) * 4
        launches.append({"bytes": nbytes, "ops": e * g * 2 * n + 2 * out,
                         "heads": heads, "n": n, "E": e, "G": g, "F": f})
        i += heads
    return launches


def bound_s(launch: dict) -> float:
    """The least time of one launch: max(bytes / HBM rate, operations /
    float32 rate)."""
    return max(launch["bytes"] / HBM_BYTES_PER_S,
               launch["ops"] / F32_FLOPS_PER_S)
