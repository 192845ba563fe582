"""Plain PyTorch reference of the training step: the model in training
mode (batch statistics), mean cross-entropy, backward, and
``torch.optim.SGD`` with momentum and weight decay (``d = g + wd p``,
``m = momentum m + d``, ``p = p - lr m``).  Imports nothing of the
program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def run(model: nn.Module, batches, lr: float, momentum: float,
        wd: float) -> dict:
    """SGD steps over ``batches`` (``(x NCHW float32, labels int64)``).
    Returns the loss of each step, the first step's raw gradient norms and
    momentum buffers by parameter name, and every parameter and BN running
    statistic after the last step; tensors stay on the model's device."""
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                          weight_decay=wd)
    params = dict(model.named_parameters())
    out = {"loss": []}
    for i, (x, labels) in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), labels)
        loss.backward()
        if i == 0:
            out["grad_norm"] = {n: p.grad.norm() for n, p in params.items()}
        opt.step()
        out["loss"].append(loss.detach())
        if i == 0:
            out["momentum"] = {n: opt.state[p]["momentum_buffer"].clone()
                               for n, p in params.items()}
    out["params"] = {n: p.detach().clone() for n, p in params.items()}
    out["bn"] = {n: b.clone() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
    return out
