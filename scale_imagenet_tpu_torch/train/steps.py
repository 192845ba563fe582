"""The train and eval steps (counterpart of
``scale_imagenet_tpu/train/steps.py:22-333``, its single-device branch).

``make_input_pipeline(normalize, augment)`` is the on-device input stage:
uint8 -> f32 / 255 -> (x - mean) / std, exact, optionally with the random
flip of same-size shards or the full RandomResizedCrop + flip + ColorJitter
of 256x256 pre-crop shards (``train/augment.py``), drawn from an explicit
``torch.Generator``.

``make_eval_step(apply, normalize)`` returns a step whose metrics stay on
the device (no host sync inside the step).

``make_train_step(model, opt, amp, accum, label_smooth)`` returns the
training step over a ``TrainState``:

* the forward runs in training mode: batch statistics normalise, and the
  new running statistics come back from the forward and are written once,
  after it (so ``--remat``'s recomputing backward cannot apply them twice);
* ``amp``: the JAX package's semantics, not ``torch.autocast``.  Every
  floating parameter, BN statistic and the images are cast to bf16 and the
  whole forward, BN included, runs in bf16 (``torch.func.functional_call``
  over the bf16 copies); gradients reach the f32 masters through the cast,
  the loss is taken on f32 logits, and the new running statistics are cast
  back into the f32 buffers.  Autocast keeps BN and reductions in f32,
  which is another function;
* ``accum``: ``accum`` sequential microbatches, each with its own BN batch
  statistics and the running statistics threaded from one to the next;
  gradients, loss and top-1/5 averaged; one optimizer update;
* a model whose forward draws coin flips (``TT_FHE_small``'s dead zones)
  takes a ``NoiseKey`` a step (``noise``; microbatch i its child i, as the
  JAX step folds its key);
* metrics are device tensors: nothing in the step waits for the card.

The mesh, tensor-parallel and robust steps come with later slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
from torch import nn

from .augment import make_rrc_flip_jitter
from .losses import accuracy_topk, cross_entropy, masked_metric_sums


@dataclasses.dataclass
class TrainState:
    """``model`` holds the params and the BN running statistics,
    ``opt_state`` the optimizer's tensors by parameter name
    (``train/optim.py``), ``step`` the number of updates taken."""
    model: nn.Module
    opt_state: dict
    step: int = 0


def make_input_pipeline(normalize=None, augment=False,
                        image_size: int = 224, dtype=torch.float32):
    """Returns ``prepare(images, generator=None) -> images``.

    ``normalize``: optional per-channel ``(mean, std)`` on the [0, 1] scale
    for uint8 NHWC batches; float batches (already normalized on the host)
    pass.  ``augment``: False | True (a random horizontal flip after
    normalizing, for same-size shards) | "full" (RandomResizedCrop + flip +
    ColorJitter + normalize from pre-crop shards, in ``dtype``); both draw
    from ``generator``, which must live on the images' device."""
    if augment == "full":
        return make_rrc_flip_jitter(out_size=image_size, normalize=normalize,
                                    dtype=dtype)
    mean_np = std_np = None
    if normalize is not None:
        mean_np = np.asarray(normalize[0], np.float32)
        std_np = np.asarray(normalize[1], np.float32)
    stats: dict = {}

    def prepare(images: torch.Tensor, generator=None) -> torch.Tensor:
        if mean_np is not None and images.dtype == torch.uint8:
            if images.device not in stats:
                stats[images.device] = (
                    torch.from_numpy(mean_np).to(images.device),
                    torch.from_numpy(std_np).to(images.device))
            mean, std = stats[images.device]
            images = (images.float() / 255.0 - mean) / std
        if augment:
            flip = torch.rand(images.shape[0], generator=generator,
                              device=images.device) < 0.5
            images = torch.where(flip[:, None, None, None],
                                 images.flip(2), images)
        return images

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


def _bf16_values(model: nn.Module) -> dict:
    """Every floating parameter and buffer of ``model`` cast to bf16 (the
    parameters' casts carry gradients back to the f32 masters); the rest
    as they are."""
    return {n: t.to(torch.bfloat16) if t.is_floating_point() else t
            for n, t in itertools.chain(model.named_parameters(),
                                        model.named_buffers())}


@torch.no_grad()
def _write_bn_stats(stats: dict) -> None:
    """The new running statistics of one forward, into the BN buffers (cast
    to the buffers' dtype)."""
    for bn, (mean, var) in stats.items():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def make_train_step(model: nn.Module, opt, amp: bool = False,
                    normalize=None, augment=False, accum: int = 1,
                    label_smooth: float = 0.0):
    """Returns ``train_step(ts, images, labels, generator=None, noise=None)
    -> (ts, metrics)``: one optimizer update of ``ts`` in place,
    ``ts.step`` + 1.  ``model`` is ``ts.model`` (a ``TTnetImageNet``'s
    ``cfg.remat`` selects the recomputing backward); ``opt`` the
    ``train/optim.py`` optimizer.  ``generator`` draws the augmentation on
    the images' device, ``noise`` (a ``NoiseKey``) keys the coin flips of a
    stochastic forward, which then needs it.  Metrics: ``loss``, ``top1``,
    ``top5`` as device scalars."""
    prepare = make_input_pipeline(
        normalize, augment, image_size=model.cfg.image_size,
        dtype=torch.bfloat16 if amp else torch.float32)
    params = dict(model.named_parameters())

    def micro(images, labels, generator, noise):
        """Forward and backward of one microbatch; gradients accumulate
        into ``.grad``; the BN statistics are written after it."""
        images = prepare(images, generator)
        stats: dict = {}
        kwargs = {"stats": stats}
        if noise is not None:
            kwargs["noise"] = noise
        if amp:
            logits = torch.func.functional_call(
                model, _bf16_values(model), (images.to(torch.bfloat16),),
                kwargs).float()
        else:
            logits = model(images, **kwargs)
        loss = cross_entropy(logits, labels, smoothing=label_smooth)
        loss.backward()
        _write_bn_stats(stats)
        top1, top5 = accuracy_topk(logits.detach(), labels, topk=(1, 5))
        return loss.detach(), top1, top5

    def train_step(ts: TrainState, images, labels, generator=None,
                   noise=None):
        if images.shape[0] % accum:
            raise ValueError(f"batch {images.shape[0]} is not divisible "
                             f"by accum={accum}")
        for p in params.values():
            p.grad = None
        mb = images.shape[0] // accum
        sums = None
        for i in range(accum):
            key = noise.child(i) if noise is not None and accum > 1 \
                else noise
            out = micro(images[i * mb:(i + 1) * mb],
                        labels[i * mb:(i + 1) * mb], generator, key)
            sums = out if sums is None else tuple(
                a + b for a, b in zip(sums, out))
        grads = {n: p.grad for n, p in params.items()}
        if accum > 1:
            torch._foreach_mul_(list(grads.values()), 1.0 / accum)
            sums = tuple(s * (1.0 / accum) for s in sums)
        opt.update(params, grads, ts.opt_state, ts.step)
        ts.step += 1
        return ts, dict(zip(("loss", "top1", "top5"), sums))

    return train_step
