"""Space-to-depth stem (counterpart of ``scale_imagenet_tpu/pallas/stem.py:27,41``).

Not a kernel on either side: the reference stem AvgPool2d(2) -> Conv(3->p,
k7, s2, p3) is folded into one conv (both are linear), then re-blocked by
space-to-depth into a 4x4 stride-1 conv over 48 channels.  Exact up to float
summation order:

    y = conv7_s2_p3(avgpool2(x))
      = conv14_s4_p6(x)                    w14[a, b] = w7[a // 2, b // 2] / 4
      = conv4_s1_valid(S2D4(pad6(x)))      w_s2d from w14 zero-padded to 16x16

NCHW activations, OIHW weights; the space-to-depth channel order is
``(di * 4 + dj) * C + c``, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fold_avgpool_into_stem_weight(w7: torch.Tensor) -> torch.Tensor:
    """OIHW ``(p, 3, 7, 7)`` -> s2d conv weight ``(p, 48, 4, 4)``."""
    o, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem fold expects the 7x7 kernel, got {kh}x{kw}")
    w14 = w7.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3) / 4.0
    w16 = F.pad(w14, (0, 2, 0, 2))
    w = w16.reshape(o, c, 4, 4, 4, 4)            # (O, C, A, di, B, dj)
    w = w.permute(0, 3, 5, 1, 2, 4)              # (O, di, dj, C, A, B)
    return w.reshape(o, 16 * c, 4, 4)


def space_to_depth_stem(x: torch.Tensor, w7: torch.Tensor) -> torch.Tensor:
    """avgpool2 + conv7s2p3 as one s2d conv; ``x`` is NCHW with H, W
    divisible by 8 (224 in every reference config)."""
    h, w = x.shape[2:]
    return s2d_conv(F.pad(x, (*stem_pad(w), *stem_pad(h))), w7)


def stem_pad(size: int) -> tuple:
    """The zeros before and after a side of ``size`` pixels: 6 (the
    folded conv's padding) and up to the next multiple of 4."""
    return 6, 6 + -(-(size + 12) // 4) * 4 - (size + 12)


def s2d_conv(xp: torch.Tensor, w7: torch.Tensor) -> torch.Tensor:
    """The folded conv on NCHW ``xp`` already padded on both sides (H and
    W multiples of 4): output row ``o`` reads padded rows ``[4o, 4o +
    16)``."""
    b, c, hp4, wp4 = xp.shape
    xb = xp.reshape(b, c, hp4 // 4, 4, wp4 // 4, 4)
    xb = xb.permute(0, 3, 5, 1, 2, 4).reshape(b, 16 * c, hp4 // 4, wp4 // 4)
    return F.conv2d(xb, fold_avgpool_into_stem_weight(w7))
