"""The eval step (counterpart of ``scale_imagenet_tpu/train/steps.py:29-200``,
its eval branch).

``make_input_pipeline(normalize)`` is the on-device input stage of the
shard pipeline: uint8 -> f32 / 255 -> (x - mean) / std, exact, on the
batch's device.  ``make_eval_step(apply, normalize)`` returns a step whose
metrics stay on the device (no host sync inside the step).  The mesh,
spatial, certified and adversarial variants and the train step come with
later slices (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from .losses import masked_metric_sums


def make_input_pipeline(normalize=None):
    """Returns ``prepare(images) -> images``.  ``normalize``: optional
    per-channel ``(mean, std)`` on the [0, 1] scale for uint8 NHWC
    batches; float batches (already normalized on the host) pass.  The
    training augmentation comes with training (``ROADMAP.md``)."""
    if normalize is None:
        return lambda images: images
    mean_np = np.asarray(normalize[0], np.float32)
    std_np = np.asarray(normalize[1], np.float32)
    stats: dict = {}

    def prepare(images: torch.Tensor) -> torch.Tensor:
        if images.dtype != torch.uint8:
            return images
        if images.device not in stats:
            stats[images.device] = (torch.from_numpy(mean_np).to(
                images.device), torch.from_numpy(std_np).to(images.device))
        mean, std = stats[images.device]
        return (images.float() / 255.0 - mean) / std

    return prepare


def make_eval_step(apply, normalize=None):
    """``apply``: NHWC float images -> logits (the conv or the LUT
    forward).  Returns ``eval_step(images, labels) -> {"loss", "top1",
    "top5", "n"}``, device scalars; labels < 0 mark pad rows, which the
    sums leave out."""
    prepare = make_input_pipeline(normalize)

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        logits = apply(prepare(images))
        nll_sum, (c1, c5), n = masked_metric_sums(logits, labels)
        denom = n.clamp(min=1.0)
        return {"loss": nll_sum / denom, "top1": 100.0 * c1 / denom,
                "top5": 100.0 * c5 / denom, "n": n}

    return eval_step
