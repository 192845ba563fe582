"""The train and eval steps (counterpart of
``scale_imagenet_tpu/train/steps.py``, its single-device branch).

``make_input_pipeline(normalize, augment)`` is the on-device input stage:
uint8 -> f32 / 255 -> (x - mean) / std, exact, optionally with the random
flip of same-size shards or the full RandomResizedCrop + flip + ColorJitter
of 256x256 pre-crop shards (``train/augment.py``), drawn from an explicit
``torch.Generator``.

``make_eval_step(apply, normalize, ...)`` returns a step whose metrics stay
on the device (no host sync inside the step).  With ``certify_eps`` it
also reports ``cert``, the certified top-1 % (correct and provably stable
over the eps-ball, through the model definition's ``interval_logits``),
and with ``attack`` ``adv``, the top-1 % under FGSM or PGD
(``robust/attack.py``): both radii in pixel units, mapped through the
input normalization by ``_pixel_ball`` (``steps.py:70-200``).

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

``make_robust_train_step`` composes the reference's robustness losses
(``steps.py:336-475``): the multi-sample stability loss, the
interval-arithmetic one and the bias regulariser.

Data parallelism (the JAX steps' ``shard_map`` branch, ``steps.py:308-345,
437-470``): each rank runs the step on its slice of the batch, and
``parallel/data_parallel.py::all_reduce_mean_`` is called once after the
gradient phase, all microbatches done, on the gradients, the new BN running
statistics and the metrics: their means over the ranks of ``group`` (the
mesh's data axis), as JAX's ``pmean``s over ``data``; then each rank takes
the same update.  Without a process group of several ranks it does
nothing.  The tensor-parallel step is this step over a rank's channel
slice of the model (``parallel/tp.py::TPTTnetImageNet``), whose classifier
sums its partial products over the model axis.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch
from torch import nn

from ..parallel.data_parallel import all_reduce_mean_
from ..parallel.sp import SP_MESH, local_rows, row_shard
from ..parallel.sp_models import sp_interval_logits
from ..robust.attack import fgsm_attack, frozen, pgd_attack
from ..robust.collect import multi_sample_forward
from ..robust.interval import certified_mask
from ..robust.regularizer import bias_regularizer_loss, \
    bn_internals_collector
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


def _pixel_ball(eps: float, stats):
    """An L-inf ball of ``eps`` in pixel ([0, 1]) units through the input
    normalization ``stats = (mean, std)``: the per-channel radius
    ``eps / std`` and clip bounds ``(0 - mean) / std``, ``(1 - mean) /
    std``, f32 CPU tensors; ``stats=None``: raw [0, 1] inputs."""
    if stats is None:
        return eps, 0.0, 1.0
    mean = torch.tensor(np.asarray(stats[0]), dtype=torch.float32)
    std = torch.tensor(np.asarray(stats[1]), dtype=torch.float32)
    return eps / std, (0.0 - mean) / std, (1.0 - mean) / std


def _on(ball: tuple, device) -> tuple:
    return tuple(b.to(device) if isinstance(b, torch.Tensor) else b
                 for b in ball)


def make_eval_step(apply, normalize=None, noise=None, md=None, model=None,
                   certify_eps: float = 0.0, certify_stats=None,
                   attack=None, mesh=None, spatial: bool = False):
    """``apply(x, **kw)``: NHWC float images -> logits (the conv, LUT or
    gate forward).  Returns ``eval_step(images, labels) -> {"loss",
    "top1", "top5", "n"}``, device scalars; labels < 0 mark pad rows, which
    the sums leave out.

    ``noise``: the root ``NoiseKey`` of a stochastic forward: batch i is
    keyed by ``noise.child(i)`` (passed as ``apply(x, noise=...)``), as the
    JAX step folds a per-call counter into its key, so a run repeats from
    its seed.

    ``certify_eps`` > 0 adds ``cert``: the model definition ``md``'s
    ``interval_logits`` of ``model`` over the ball of that radius; a model
    without the hook is refused.  ``attack``: ``{"kind": "fgsm"|"pgd",
    "eps", "steps", "step_size"}`` in pixel units adds ``adv``, the top-1
    of ``apply`` on the attacked images, each attack step keyed as
    ``pgd_attack`` says and ``model``'s parameters frozen meanwhile.
    ``certify_stats``: the ``(mean, std)`` the inputs were normalized with
    (both balls); ``None`` means raw [0, 1] inputs.

    ``spatial``: the image height is sharded over ``mesh``'s model axis
    (``--sp``): each batch comes whole to every rank of a model group,
    which keeps its own rows on the device (``parallel/sp.py``), and
    ``apply`` is the row-sharded forward (``sp_forward``), the same logits
    on every rank; ``cert`` bounds the logits through the family's
    row-sharded interval twin (``sp_interval_logits``).  An attacked image
    stays row-sharded: the sign step and the projection are row-local."""
    if spatial and mesh is None:
        raise ValueError(SP_MESH)
    prepare = make_input_pipeline(normalize)
    shard = row_shard(mesh) if spatial else None
    rows = functools.partial(local_rows, shard=shard) if spatial \
        else (lambda images: images)
    if certify_eps > 0:
        if md is None or md.interval_logits is None:
            name = "the model" if md is None else md.name
            raise ValueError(
                f"{name} has no interval_logits hook — certified eval "
                "supports the AbstractTensor families (tt_certif, "
                "cifar10lownoise, model_general)")
        cball = _pixel_ball(certify_eps, certify_stats)
        interval_logits = functools.partial(md.interval_logits, model) \
            if shard is None else sp_interval_logits(model, shard)
    if attack is not None:
        aball = _pixel_ball(attack["eps"], certify_stats)
        astep = None
        if attack.get("step_size"):
            astep = _pixel_ball(attack["step_size"], certify_stats)[0]
    calls = itertools.count()

    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        kw = {} if noise is None else {"noise": noise.child(next(calls))}
        # the attack differentiates tensors made here: no inference mode
        with torch.no_grad() if attack is not None \
                else torch.inference_mode():
            x = prepare(rows(images))
            logits = apply(x, **kw)
            nll_sum, (c1, c5), n = masked_metric_sums(logits, labels)
            denom = n.clamp(min=1.0)
            out = {"loss": nll_sum / denom, "top1": 100.0 * c1 / denom,
                   "top5": 100.0 * c5 / denom, "n": n}
            if certify_eps > 0:
                iv = interval_logits(x, *_on(cball, x.device))
                preds = logits.argmax(-1)
                ok = (labels >= 0) & certified_mask(iv, preds) \
                    & (preds == labels)
                out["cert"] = 100.0 * ok.float().sum() / denom
            if attack is not None:
                eps, lo, hi = _on(aball, x.device)
                with frozen(model):
                    if attack["kind"] == "fgsm":
                        adv = fgsm_attack(apply, x, labels, eps, lo, hi,
                                          noise=kw.get("noise"))
                    else:
                        step = None if astep is None \
                            else _on((astep,), x.device)[0]
                        adv = pgd_attack(apply, x, labels, eps,
                                         steps=attack.get("steps", 10),
                                         step_size=step, lo=lo, hi=hi,
                                         noise=kw.get("noise"))
                _, (a1, _), _ = masked_metric_sums(apply(adv, **kw), labels)
                out["adv"] = 100.0 * a1 / denom
        return out

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


def _bn_buffers(written: dict) -> list:
    """The running statistics of the BNs a step wrote, in forward order
    (the same on every rank)."""
    return [t for bn in written for t in (bn.running_mean, bn.running_var)]


def make_train_step(model: nn.Module, opt, amp: bool = False,
                    normalize=None, augment=False, accum: int = 1,
                    label_smooth: float = 0.0, group=None):
    """Returns ``train_step(ts, images, labels, generator=None, noise=None)
    -> (ts, metrics)``: one optimizer update of ``ts`` in place,
    ``ts.step`` + 1.  ``model`` is ``ts.model`` (a ``TTnetImageNet``'s
    ``cfg.remat`` selects the recomputing backward); ``opt`` the
    ``train/optim.py`` optimizer.  ``generator`` draws the augmentation on
    the images' device, ``noise`` (a ``NoiseKey``) keys the coin flips of a
    stochastic forward, which then needs it.  Metrics: ``loss``, ``top1``,
    ``top5`` as device scalars, averaged over the ranks of ``group`` (a
    mesh's ``data_group``; None: every rank; module docstring)."""
    prepare = make_input_pipeline(
        normalize, augment, image_size=model.cfg.image_size,
        dtype=torch.bfloat16 if amp else torch.float32)
    params = dict(model.named_parameters())

    def micro(images, labels, generator, noise, written):
        """Forward and backward of one microbatch; gradients accumulate
        into ``.grad``; the BN statistics are written after it, and their
        BNs noted in ``written``."""
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
        written.update(dict.fromkeys(stats))
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
        written: dict = {}
        for i in range(accum):
            key = noise.child(i) if noise is not None and accum > 1 \
                else noise
            out = micro(images[i * mb:(i + 1) * mb],
                        labels[i * mb:(i + 1) * mb], generator, key,
                        written)
            sums = out if sums is None else tuple(
                a + b for a, b in zip(sums, out))
        grads = {n: p.grad for n, p in params.items()}
        if accum > 1:
            torch._foreach_mul_(list(grads.values()), 1.0 / accum)
            sums = tuple(s * (1.0 / accum) for s in sums)
        all_reduce_mean_([*grads.values(), *_bn_buffers(written), *sums],
                         group)
        opt.update(params, grads, ts.opt_state, ts.step)
        ts.step += 1
        return ts, dict(zip(("loss", "top1", "top5"), sums))

    return train_step


def make_robust_train_step(md, model: nn.Module, opt, eps: float,
                           coeff: float, normalize=None, augment=False,
                           input_bounds=None, abstract_eps: float = 0.0,
                           abstract_coeff: float = 0.0,
                           bias_coeff: float = 0.0,
                           bias_thresh: float = 0.0, group=None):
    """The training step with the reference's robustness losses, which
    compose (``steps.py:336-475``):

    * ``eps``/``coeff``: the multi-sample activation-stability loss, CE +
      coeff * rsloss (netbin.py:710-724), the natural batch its own
      adversarial sample; BN's new statistics come from the packed 3N
      forward, as in the reference, with no second forward;
    * ``abstract_eps``/``abstract_coeff``: the interval-arithmetic
      stabilization loss of ``md.interval_loss`` (netbin.py:726-738),
      reported with the first as ``stability_loss``;
    * ``bias_coeff``/``bias_thresh``: the bias regulariser over every
      ``stats_bn`` forward's effective ``(scale, bias)``.

    ``normalize``/``augment``: as ``make_train_step``.  ``input_bounds``:
    the ``(min, max)`` of the images as the model sees them, for images
    normalized on the host; with ``normalize`` they are derived, else
    [0, 1].  Returns ``train_step(ts, images, labels, generator=None,
    noise=None) -> (ts, metrics)``; ``noise`` (a ``NoiseKey``, needed when
    ``eps`` > 0 or the model draws coin flips) splits as the JAX key:
    ``child(0)`` the signs, ``child(1)`` the forward's flips.  Over
    several ranks the step averages as ``make_train_step``'s
    (``stability_loss`` too)."""
    if abstract_coeff > 0 and md.interval_loss is None:
        raise ValueError(
            f"model {md.name} has no interval-arithmetic forward "
            "(the reference propagates AbstractTensor only through the "
            "cifar10lownoise family); drop --abstract_coeff")
    prepare = make_input_pipeline(normalize, augment,
                                  image_size=model.cfg.image_size)
    if normalize is not None:
        m = torch.tensor(np.asarray(normalize[0]), dtype=torch.float32)
        s = torch.tensor(np.asarray(normalize[1]), dtype=torch.float32)
        bounds = ((0.0 - m) / s, (1.0 - m) / s)
    elif input_bounds is not None:
        bounds = tuple(torch.tensor(np.asarray(b), dtype=torch.float32)
                       for b in input_bounds)
    else:
        bounds = (0.0, 1.0)
    stochastic = getattr(model.cfg, "stochastic", False)
    params = dict(model.named_parameters())

    def train_step(ts: TrainState, images, labels, generator=None,
                   noise=None):
        for p in params.values():
            p.grad = None
        images = prepare(images, generator)
        lo, hi = _on(bounds, images.device)
        with bn_internals_collector() as bn_c:
            if eps > 0:
                logits, sloss, stats = multi_sample_forward(
                    model, images, images, eps, noise, lo, hi,
                    return_state=True)
            else:
                stats = {}
                kw = {"noise": noise} if stochastic else {}
                logits = model(images, stats, **kw)
                sloss = torch.zeros((), device=images.device)
        loss = cross_entropy(logits, labels) + coeff * sloss
        if abstract_coeff > 0:
            aloss = md.interval_loss(model, images, abstract_eps, lo, hi)
            sloss = sloss + aloss    # reported together, as the
            loss = loss + abstract_coeff * aloss     # reference's .loss
        if bias_coeff > 0:
            if not bn_c.pairs:
                # the regulariser would add 0 forever: no accepted flag may
                # do nothing
                raise ValueError(
                    f"model {md.name} has no BatchNormStatsCallbak-style "
                    "BN (stats_bn) in its forward; --bias_decay "
                    "regularizes those internals only (the reference's "
                    "BiasRegularizer target, netbin.py:786-864) — drop "
                    "the flag for this model")
            loss = loss + bias_regularizer_loss(bn_c.pairs, bias_coeff,
                                                bias_thresh)
        loss.backward()
        _write_bn_stats(stats)
        top1, top5 = accuracy_topk(logits.detach(), labels, topk=(1, 5))
        grads = {n: p.grad for n, p in params.items()}
        metrics = {"loss": loss.detach(), "top1": top1, "top5": top5,
                   "stability_loss": sloss.detach()}
        all_reduce_mean_([*grads.values(), *_bn_buffers(stats),
                          *metrics.values()], group)
        opt.update(params, grads, ts.opt_state, ts.step)
        ts.step += 1
        return ts, metrics

    return train_step
