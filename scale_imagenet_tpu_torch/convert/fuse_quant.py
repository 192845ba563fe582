"""Fused-quant serving of the DoReFa ResNets (counterpart of
``scale_imagenet_tpu/convert/fuse_quant.py:24-63``): every block conv's
weight DoReFa-quantized once (the stem stays float), every conv/BN pair
folded, the downsample pairs included, and the model served at
``wbit = 32``, so that the forward quantizes its activations alone."""

from __future__ import annotations

import dataclasses

import torch

from ..models.resnet import ResNet
from ..ops.dorefa import dorefa_w
from .bn_fold import conv_bn_pairs_resnet, fold_bn_into_conv


@torch.no_grad()
def quantize_resnet_weights(model: ResNet, nbit_w: int) -> None:
    """``dorefa_w`` of every block conv weight, in place
    (``fuse_quant.py:24``)."""
    for name in model.block_names:
        block = getattr(model, name)
        for conv in (getattr(block, f"conv{i}", None) for i in (1, 2, 3)):
            if conv is not None:
                conv.weight.copy_(dorefa_w(conv.weight, nbit_w))
        if block.down_conv is not None:
            block.down_conv.weight.copy_(dorefa_w(block.down_conv.weight,
                                                  nbit_w))


def fuse_resnet(model: ResNet) -> int:
    """Quantize the weights at the model's ``wbit``, fold every BN into
    its conv (``fuse_quant.py:38``) and set ``wbit`` to 32, in place.
    Returns the number of pairs folded."""
    quantize_resnet_weights(model, model.cfg.wbit)
    pairs = conv_bn_pairs_resnet(model)
    for name in model.block_names:
        block = getattr(model, name)
        if block.down_conv is not None:
            pairs.append((block.down_conv, block.down_bn))
    for conv, bn in pairs:
        fold_bn_into_conv(conv, bn)
    model.cfg = dataclasses.replace(model.cfg, wbit=32)
    return len(pairs)
