"""Losses and metrics (counterpart of
``scale_imagenet_tpu/train/losses.py``)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over the batch (torch ``nn.CrossEntropyLoss`` semantics,
    incl. its ``label_smoothing``: target = (1-s)·one_hot + s/C)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if smoothing > 0.0:
        nll = (1.0 - smoothing) * nll + smoothing * -logp.mean(-1)
    return nll.mean()


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  topk=(1,)) -> list[torch.Tensor]:
    """Top-k accuracy in percent."""
    pred = torch.topk(logits, max(topk), dim=-1).indices
    correct = pred == labels[:, None]
    return [100.0 * correct[:, :k].any(1).float().mean() for k in topk]


def masked_metric_sums(logits: torch.Tensor, labels: torch.Tensor,
                       topk=(1, 5)):
    """Per-batch metric SUMS where ``labels < 0`` mark pad rows (the final
    short batch is padded to the full batch size, ``data/loader.py``).
    Returns ``(nll_sum, [correct_k_sum, ...], n_valid)`` as device
    tensors; on a full batch these are exactly the unmasked sums."""
    mask = (labels >= 0).float()
    safe = labels.long().clamp(min=0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    pred = torch.topk(logits, max(topk), dim=-1).indices
    correct = pred == safe[:, None]
    sums = [(correct[:, :k].any(1).float() * mask).sum() for k in topk]
    return (nll * mask).sum(), sums, mask.sum()
