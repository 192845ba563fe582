"""Weights from the seed, made on the device in two large draws.

Every conv and linear weight and bias is uniform in +-1/sqrt(fan_in) (the
default initialisation of ``nn.Conv2d``/``nn.Linear``, which the program's
``init(seed)`` also draws); every BN has weight 1 and bias 0.  The BN
running statistics are then those of one training-mode forward of the
plain reference over ``CALIBRATION`` seeded images (momentum 1), so that
each BN normalises what reaches it, as in a trained network: left at a
fresh initialisation's mean 0 and variance 1 (perturbed or not), v1's
2-bit activations round nearly everything to one level and its logits
hardly depend on the image (their spread across images is 5e-5 of their
norm).  The draws go into the reference's module tree, whose names the
program's model shares; the caller hands the same state dict to the
program and, after the window, to the reference.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_BN = nn.modules.batchnorm._BatchNorm
CALIBRATION = 32        # images of the BN statistics' forward
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def fill(model: nn.Module, seed: int, image_size: int) -> nn.Module:
    """Every parameter and buffer of ``model`` (the reference, already on
    its device) from ``seed``: one uniform draw for all conv and linear
    tensors, then the calibration images, from a generator on the device;
    returned in eval mode."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = [m for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    bns = [m for m in model.modules() if isinstance(m, _BN)]
    leaves = [(t, 1.0 / math.sqrt(m.weight[0].numel()))
              for m in dense for t in (m.weight, m.bias) if t is not None]
    u = torch.rand(sum(t.numel() for t, _ in leaves), generator=g,
                   device=dev)
    for (t, bound), part in zip(leaves, u.split([t.numel()
                                                 for t, _ in leaves])):
        t.copy_(part.view_as(t) * (2 * bound) - bound)
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.weight.fill_(1.0)
        m.bias.zero_()
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
        m.momentum = 1.0
    images = torch.randint(0, 256, (CALIBRATION, 3, image_size, image_size),
                           generator=g, device=dev, dtype=torch.uint8)
    mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)
    model.train()(((images.float() / 255.0) - mean) / std)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
        m.num_batches_tracked.zero_()
    for name, buf in model.named_buffers():
        if name.endswith("grad_scale"):
            buf.fill_(1.0)
    return model.eval()
