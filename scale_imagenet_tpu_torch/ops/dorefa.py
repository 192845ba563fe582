"""DoReFa-Net quantization (counterpart of
``scale_imagenet_tpu/ops/dorefa.py``): ``scale_sign`` (``sign(x) *
mean|x|``), the k-bit ``dorefa_quantize``, and the weight and activation
transforms of the quantized ResNets, each with the identity
straight-through gradient around its rounding."""

from __future__ import annotations

import torch

from .quantize import _ste, clip


def scale_sign(x: torch.Tensor) -> torch.Tensor:
    """``sign(x) * mean(|x|)`` with the identity gradient."""
    return _ste(x, torch.sign(x) * x.abs().mean())


def dorefa_quantize(x: torch.Tensor, nbit: int) -> torch.Tensor:
    """``round(x * (2^nbit - 1)) / (2^nbit - 1)``, identity gradient."""
    scale = float(2 ** nbit - 1)
    return _ste(x, torch.round(x * scale) / scale)


def dorefa_w(w: torch.Tensor, nbit_w: int) -> torch.Tensor:
    """DoReFa weight quantization (``dorefa.py:27``)."""
    if nbit_w == 1:
        return scale_sign(w)
    w = torch.tanh(w)
    w = w / (2 * w.abs().max()) + 0.5
    return 2 * dorefa_quantize(w, nbit_w) - 1


def dorefa_a(x: torch.Tensor, nbit_a: int) -> torch.Tensor:
    """DoReFa activation quantization (``dorefa.py:37``)."""
    return dorefa_quantize(clip(0.1 * x, 0.0, 1.0), nbit_a)
