"""BN folding: fold eval-mode BatchNorm into the preceding conv or linear
(counterpart of ``scale_imagenet_tpu/convert/bn_fold.py:24-104``).

The algebra (the reference's ``bn_fuse.py``)::

    w' = w * gamma / sqrt(var + eps)        (per output channel)
    b' = (b - mu) * gamma / sqrt(var + eps) + beta

As in the JAX package, a transform of the weights, not of the module
tree: the conv gains a bias ``Parameter`` and the BN is *neutralised* to
weight 1, bias 0, running mean 0 and running variance ``1 - eps``, which
make the eval BN the identity (``sqrt(var + eps)`` is 1).  The folded
model runs through the unchanged forwards, which add a conv's bias where
one is present.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.resnet import ResNetConfig
from ..models.ttnet_imagenet import TTnetImageNetConfig

# ``scale_imagenet_tpu/main.py:596-599``
_FAMILIES = ("--fold_bn knows the conv/BN pairing for the ttnet_imagenet "
             "and resnet families, not {}")


@torch.no_grad()
def fold_bn_into_conv(conv: nn.Conv2d | nn.Linear,
                      bn: nn.modules.batchnorm._BatchNorm) -> None:
    """Fold ``bn`` into ``conv`` in place (``bn_fold.py:24``), with the BN's
    own ``eps`` (1e-5, JAX's).  The weight's output axis is its first, for
    a conv (OIHW) and a linear ``(out, in)`` alike."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    shape = (-1,) + (1,) * (conv.weight.dim() - 1)
    bias = torch.zeros_like(bn.running_mean) if conv.bias is None \
        else conv.bias
    new_b = (bias - bn.running_mean) * scale + bn.bias
    conv.weight.mul_(scale.view(shape))
    conv.bias = nn.Parameter(new_b, requires_grad=conv.weight.requires_grad)
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0).sub_(bn.eps)


def conv_bn_pairs_ttnet_imagenet(model) -> list:
    """Every foldable ``(conv, bn)`` pair of a ttnet_imagenet model
    (``bn_fold.py:93``): the stem, both of every head and fuse head of
    every block, and the classifier's ``lin1``/``BN2``."""
    if not isinstance(model.cfg, TTnetImageNetConfig):
        raise ValueError(_FAMILIES.format(type(model.cfg).__name__))
    pairs = [(model.stem_conv, model.stem_bn)]
    for block in model.blocks:
        for i in sorted(block.cfg.head_cfgs()):
            head = block.head(i)
            pairs += [(head.conv1, head.bn1), (head.conv2, head.bn2)]
        pairs += [(block.Block_convf.conv1, block.Block_convf.bn1),
                  (block.Block_convf.conv2, block.Block_convf.bn2)]
    pairs.append((model.classifier.lin1, model.classifier.BN2))
    return pairs


def conv_bn_pairs_resnet(model) -> list:
    """The pairs ``--fold_bn`` folds in a DoReFa ResNet (``bn_fold.py:105``):
    the stem and every block's ``conv{i}``/``bn{i}``; the downsample pair
    stays unfolded, as in the JAX package.  A folded conv's weight is
    quantized again at ``wbit < 32``, which changes the function: that is
    ``--fuse_quant``'s case (``convert/fuse_quant.py``)."""
    pairs = [(model.conv1, model.bn1)]
    for name in model.block_names:
        block = getattr(model, name)
        pairs += [(getattr(block, f"conv{i}"), getattr(block, f"bn{i}"))
                  for i in range(1, 4) if hasattr(block, f"conv{i}")]
    return pairs


def fold_model_bns(model) -> int:
    """Fold every conv/BN pair of a ttnet_imagenet model
    (``conv_bn_pairs_ttnet_imagenet``) or a ResNet (``conv_bn_pairs_resnet``)
    in place (``bn_fold.py:65``).  Returns the number of pairs folded."""
    pairs = conv_bn_pairs_resnet(model) \
        if isinstance(model.cfg, ResNetConfig) \
        else conv_bn_pairs_ttnet_imagenet(model)
    for conv, bn in pairs:
        fold_bn_into_conv(conv, bn)
    return len(pairs)
