"""Plain PyTorch reference of the training augmentation: RandomResizedCrop
(torchvision's ten-attempt rule, then the centre square), horizontal flip
and ColorJitter(0.5, 0.5, 0.3) in a random order, on uint8 pre-crops,
then the ImageNet normalization.  The random choices are drawn from the
given ``torch.Generator`` in this order: crop areas (B, 10), log aspect
ratios (B, 10), crop positions (B, 2), flips (B,), jitter factors (B, 3),
the jitter order (B,) as integers below 6; so the same seed draws the
same choices as the program's augmentation, which draws in that order.
The crop is resampled bilinearly with pixel centres mapped to the crop
box and clamped to it (no antialias); the jitter stages are applied one
after another in the drawn order, in float, with no rounding between
them.  Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

GRAY = (0.299, 0.587, 0.114)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ORDERS = ("bcs", "bsc", "cbs", "csb", "sbc", "scb")


def _crops(n, s, g):
    dev = g.device
    area = float(s * s)
    u = torch.rand((n, 10), generator=g, device=dev)
    ta = area * (0.08 + 0.92 * u)
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    aspect = torch.exp(lo + (hi - lo) * torch.rand((n, 10), generator=g,
                                                   device=dev))
    cw = torch.round(torch.sqrt(ta * aspect))
    ch = torch.round(torch.sqrt(ta / aspect))
    ok = (cw > 0) & (cw <= s) & (ch > 0) & (ch <= s)
    pos = torch.rand((n, 2), generator=g, device=dev)
    out = []
    for i in range(n):
        hits = ok[i].nonzero()
        if len(hits):
            j = int(hits[0])
            h, w = float(ch[i, j]), float(cw[i, j])
            top = math.floor(float(pos[i, 0]) * (s - h + 1))
            left = math.floor(float(pos[i, 1]) * (s - w + 1))
        else:
            h = w = float(s)
            top = left = math.floor((s - h) / 2)
        out.append((top, left, h, w))
    return out


def _resample(img, top, left, h, w, size):
    """Bilinear, one image (S, S, C) float -> (size, size, C)."""
    def axis(start, length):
        step = torch.tensor(length, device=img.device) / size
        r = (torch.arange(size, dtype=torch.float32, device=img.device)
             + 0.5) * step + start - 0.5
        r = r.clamp(start, start + length - 1)
        p0 = r.floor()
        wt = r - p0
        p1 = torch.minimum(p0 + 1, torch.tensor(start + length - 1.0,
                                                device=img.device))
        return p0.long(), p1.long(), wt
    r0, r1, rw = axis(top, h)
    c0, c1, cwt = axis(left, w)
    rows = img[r0] * (1 - rw)[:, None, None] + img[r1] * rw[:, None, None]
    return rows[:, c0] * (1 - cwt)[None, :, None] \
        + rows[:, c1] * cwt[None, :, None]


def augment(images_u8: torch.Tensor, g: torch.Generator,
            size: int) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (B, size, size, 3) normalized float32."""
    n, s = images_u8.shape[:2]
    crops = _crops(n, s, g)
    flips = torch.rand(n, generator=g, device=g.device) < 0.5
    f = torch.rand((n, 3), generator=g, device=g.device)
    order = torch.randint(0, 6, (n,), generator=g, device=g.device)
    gray_w = torch.tensor(GRAY, device=images_u8.device)
    mean = torch.tensor(MEAN, device=images_u8.device)
    std = torch.tensor(STD, device=images_u8.device)
    out = []
    for i in range(n):
        x = _resample(images_u8[i].float() / 255.0, *crops[i], size)
        if flips[i]:
            x = x.flip(1)
        factors = {"b": 1 + 0.5 * (2 * float(f[i, 0]) - 1),
                   "c": 1 + 0.5 * (2 * float(f[i, 1]) - 1),
                   "s": 1 + 0.3 * (2 * float(f[i, 2]) - 1)}
        for op in ORDERS[int(order[i])]:
            k = factors[op]
            gray = (x * gray_w).sum(-1, keepdim=True)
            if op == "b":
                x = k * x
            elif op == "c":
                x = k * x + (1 - k) * gray.mean()
            else:
                x = k * x + (1 - k) * gray
        out.append(((x.clamp(0.0, 1.0) - mean) / std))
    return torch.stack(out)
