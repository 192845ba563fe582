"""On-device training augmentation: RandomResizedCrop + HFlip + ColorJitter
from uint8 pre-crop shards (counterpart of
``scale_imagenet_tpu/train/augment.py:42-175``).

The reference recipe (RandomResizedCrop(224) + RandomHorizontalFlip +
ColorJitter(0.5, 0.5, 0.3)) runs on the card for a whole batch, from
256x256 uint8 pre-crops (``--write_shards --shards_split train``).

Sampling is split from applying.  ``sample_crops``, ``sample_flips`` and
``sample_jitter`` draw every random choice of a batch from an explicit
``torch.Generator`` on the batch's device; ``apply_rrc_flip_jitter`` is a
deterministic function of the images and those draws, so it can be held
against the JAX package's ``make_rrc_flip_jitter`` given the JAX draws.

* The crop: torchvision's 10-attempt loop, vectorised (the first valid of
  10 candidates, else the centre square), then a separable bilinear
  resample clamped to the crop box (PIL's pixel-centre mapping, no
  antialias), as two gathers.
* ColorJitter: brightness, contrast and saturation are each affine in
  (image, per-pixel gray, mean gray), so the three in any order collapse to
  ``out = alpha * img + beta * gray + gamma * mean_gray``; one pass per
  image instead of three.
* Pixels are computed in ``dtype`` (bf16 under ``--amp``); the crop
  coordinates and the jitter coefficients stay f32.

Like the JAX path, it differs from the PIL host path in three documented
ways: no antialias when downscaling, no uint8 rounding between jitter
stages, and the crop is taken from the stored 256x256 view.
"""

from __future__ import annotations

import math

import torch

GRAY = (0.299, 0.587, 0.114)        # PIL "L"


def sample_crops(n: int, src_h: int, src_w: int, generator: torch.Generator,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision ``RandomResizedCrop.get_params`` for ``n`` images:
    ``(top, left, ch, cw)``, each ``(n,)`` f32 on the generator's device."""
    dev = generator.device
    area = float(src_h * src_w)
    u = torch.rand((n, 10), generator=generator, device=dev)
    ta = area * (scale[0] + (scale[1] - scale[0]) * u)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * torch.rand(
        (n, 10), generator=generator, device=dev))
    cw = torch.round(torch.sqrt(ta * aspect))
    ch = torch.round(torch.sqrt(ta / aspect))
    valid = (cw > 0) & (cw <= src_w) & (ch > 0) & (ch <= src_h)
    first = valid.to(torch.uint8).argmax(1, keepdim=True)
    any_valid = valid.any(1)
    s = float(min(src_h, src_w))
    cw = torch.where(any_valid, cw.gather(1, first)[:, 0], s)
    ch = torch.where(any_valid, ch.gather(1, first)[:, 0], s)
    pos = torch.rand((n, 2), generator=generator, device=dev)
    # randint(0, w - cw) inclusive == floor(u * (w - cw + 1))
    top = torch.where(any_valid, torch.floor(pos[:, 0] * (src_h - ch + 1)),
                      torch.floor((src_h - ch) / 2))
    left = torch.where(any_valid, torch.floor(pos[:, 1] * (src_w - cw + 1)),
                       torch.floor((src_w - cw) / 2))
    return top, left, ch, cw


def sample_flips(n: int, generator: torch.Generator) -> torch.Tensor:
    """``(n,)`` bool: flip each image with probability 1/2."""
    return torch.rand(n, generator=generator, device=generator.device) < 0.5


def compose_jitter_coeffs(fb, fc, fs, perm):
    """``(alpha, beta, gamma)`` of the fused jitter map for enhancer factors
    ``fb`` (brightness), ``fc`` (contrast), ``fs`` (saturation) applied in
    the order ``perm`` (an index into the 6 orders of (bri, con, sat)), as
    the JAX package composes them; all ``(n,)`` tensors."""
    def bri(c):
        a, b, g = c
        return fb * a, fb * b, fb * g

    def sat(c):
        a, b, g = c
        return fs * a, fs * b + (1.0 - fs) * (a + b), g

    def con(c):
        a, b, g = c
        return fc * a, fc * b, fc * g + (1.0 - fc) * (a + b + g)

    orders = [(bri, con, sat), (bri, sat, con), (con, bri, sat),
              (con, sat, bri), (sat, bri, con), (sat, con, bri)]
    one = torch.ones_like(fb)
    start = (one, torch.zeros_like(fb), torch.zeros_like(fb))
    triples = torch.stack([torch.stack(o[2](o[1](o[0](start))))
                           for o in orders])               # (6, 3, n)
    sel = triples[perm, :, torch.arange(fb.shape[0], device=fb.device)]
    return sel[:, 0], sel[:, 1], sel[:, 2]


def sample_jitter(n: int, generator: torch.Generator,
                  brightness: float = 0.5, contrast: float = 0.5,
                  saturation: float = 0.3):
    """ColorJitter factors U(1 - m, 1 + m) and a random order, composed:
    ``(alpha, beta, gamma)``, each ``(n,)`` f32."""
    dev = generator.device
    f = torch.rand((n, 3), generator=generator, device=dev)
    fb = 1.0 + brightness * (2.0 * f[:, 0] - 1.0)
    fc = 1.0 + contrast * (2.0 * f[:, 1] - 1.0)
    fs = 1.0 + saturation * (2.0 * f[:, 2] - 1.0)
    perm = torch.randint(0, 6, (n,), generator=generator, device=dev)
    return compose_jitter_coeffs(fb, fc, fs, perm)


def _resample_axis(img, start, length, out_size, axis, dtype):
    """Bilinear resample of ``img`` (B, H, W, C) along ``axis`` (1 or 2) to
    ``out_size`` samples of each image's ``[start, start + length)``, edge-
    clamped to the box: sample j sits at ``start + (j + .5) * length / out
    - .5``."""
    b = img.shape[0]
    r = torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5
    s = start[:, None]
    last = (start + length - 1)[:, None]
    pos = torch.clamp(s + r * (length / out_size)[:, None] - 0.5, s, last)
    p0 = torch.floor(pos)
    w = (pos - p0).to(dtype)
    p1 = torch.minimum(p0 + 1, last).long()
    p0 = p0.long()
    shape = [b, 1, 1, 1]
    shape[axis] = out_size
    w = w.view(shape)
    size = list(img.shape)
    size[axis] = out_size

    def take(p):
        return torch.gather(img, axis, p.view(shape).expand(size))
    return take(p0) * (1.0 - w) + take(p1) * w


def apply_rrc_flip_jitter(images_u8: torch.Tensor, crops, flips, jitter,
                          out_size: int = 224, normalize=None,
                          dtype=torch.float32) -> torch.Tensor:
    """The recipe on ``images_u8`` (B, S, S, C) given its draws:
    ``crops = (top, left, ch, cw)``, ``flips`` (B,) bool, ``jitter =
    (alpha, beta, gamma)``.  Returns (B, out, out, C) in ``dtype``,
    normalized with ``normalize = (mean, std)`` when given."""
    top, left, ch, cw = crops
    img = images_u8.to(dtype) / 255.0
    rows = _resample_axis(img, top, ch, out_size, 1, dtype)
    out = _resample_axis(rows, left, cw, out_size, 2, dtype)
    out = torch.where(flips[:, None, None, None], out.flip(2), out)
    a, b, g = (v.to(dtype).view(-1, 1, 1, 1) for v in jitter)
    gray = (out * torch.tensor(GRAY, dtype=dtype, device=out.device)).sum(
        -1, keepdim=True)
    out = a * out + b * gray + g * gray.mean((1, 2, 3), keepdim=True)
    out = torch.clamp(out, 0.0, 1.0)
    if normalize is not None:
        mean, std = (torch.as_tensor(v, dtype=dtype, device=out.device)
                     for v in normalize)
        out = (out - mean) / std
    return out


def make_rrc_flip_jitter(out_size: int = 224, jitter=(0.5, 0.5, 0.3),
                         scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                         normalize=None, dtype=torch.float32):
    """Returns ``augment(images_u8 (B, S, S, C), generator) -> (B, out, out,
    C)``: the draws from ``generator`` (on the images' device), then
    ``apply_rrc_flip_jitter``."""
    def augment(images_u8: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        n, s_h, s_w = images_u8.shape[:3]
        crops = sample_crops(n, s_h, s_w, generator, scale, ratio)
        flips = sample_flips(n, generator)
        coeffs = sample_jitter(n, generator, *jitter)
        return apply_rrc_flip_jitter(images_u8, crops, flips, coeffs,
                                     out_size, normalize, dtype)
    return augment
