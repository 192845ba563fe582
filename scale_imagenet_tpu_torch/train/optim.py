"""SGD with momentum, step-indexed learning rates and a params EMA
(counterpart of ``scale_imagenet_tpu/train/optim.py:11-105``).

The JAX package chains optax's ``add_decayed_weights(wd)`` and
``sgd(schedule, momentum)``; one update at step ``t`` is::

    d = g + wd * p            m = d + momentum * m          p = p + (-lr(t)) * m

which is also ``torch.optim.SGD`` with ``weight_decay``.  ``lr(t)`` is the
rate of the t-th update (t from 0).  The schedules reproduce optax's
arithmetic in Python floats: MultiStepLR by steps, multistep times a
linear warmup with the milestones kept absolute, and linear warmup into a
cosine decay.  ``params_ema(decay)`` keeps ``ema = decay * ema + (1 - decay)
* p`` from the new params after every update, starting from a copy of the
params; it lives in the optimizer state, so checkpoints carry it.

The state is a dict of tensors keyed by parameter name (``momentum``, and
``ema`` when kept); updates run as ``torch._foreach_*`` ops, a handful of
launches for the whole model, with no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def multistep_lr(base_lr: float, milestones, gamma: float = 0.1,
                 steps_per_epoch: int = 1) -> Callable[[int], float]:
    """MultiStepLR by steps: ``gamma`` once for each milestone epoch
    reached (optax ``piecewise_constant_schedule``)."""
    boundaries = {int(m * steps_per_epoch): gamma for m in milestones}
    items = sorted(boundaries.items())

    def sched(t: int) -> float:
        v = base_lr
        for boundary, scale in items:
            if t >= boundary:
                v = scale * v
        return v
    return sched


def cosine_lr(base_lr: float, max_epochs: int, steps_per_epoch: int = 1,
              warmup_epochs: float = 0) -> Callable[[int], float]:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_epochs``, then a
    cosine decay to 0 at ``max_epochs`` (optax ``linear_schedule`` joined
    to ``cosine_decay_schedule``)."""
    warmup = int(warmup_epochs * steps_per_epoch)
    total = max(int(max_epochs * steps_per_epoch), warmup + 1)
    decay_steps = float(total - warmup)

    def cos(t: int) -> float:
        t = min(float(t), decay_steps)
        return base_lr * (0.5 * (1 + math.cos(math.pi * t / decay_steps)))

    if warmup == 0:
        return cos

    def sched(t: int) -> float:
        if t >= warmup:
            return cos(t - warmup)
        frac = 1 - min(max(t, 0), warmup) / warmup
        return (0.0 - base_lr) * frac + base_lr
    return sched


@dataclasses.dataclass(frozen=True)
class ParamsEMA:
    """An exponential moving average of the params, kept in the optimizer
    state and updated after each step from the new params."""
    decay: float

    def init(self, params: dict) -> dict:
        return {n: p.detach().clone() for n, p in params.items()}

    def update(self, ema: dict, params: dict) -> None:
        e, p = list(ema.values()), [params[n].detach() for n in ema]
        torch._foreach_mul_(e, self.decay)
        torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - self.decay))


def params_ema(decay: float) -> ParamsEMA:
    return ParamsEMA(decay)


def get_ema(opt_state: dict) -> dict | None:
    """The EMA params of an optimizer state (name -> tensor), or None when
    the optimizer keeps none."""
    return opt_state.get("ema")


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD + momentum with decoupled-in-gradient weight decay and a
    step-indexed rate; ``ema`` optionally chains a params EMA after it."""
    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 1e-4
    ema: ParamsEMA | None = None

    def init(self, params: dict) -> dict:
        state = {"momentum": {n: torch.zeros_like(p.detach())
                              for n, p in params.items()}}
        if self.ema is not None:
            state["ema"] = self.ema.init(params)
        return state

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict,
               step: int) -> None:
        """One update in place: ``params`` and ``grads`` map the same
        names (``step`` is the update's index, from 0)."""
        names = list(state["momentum"])
        p = [params[n] for n in names]
        m = [state["momentum"][n] for n in names]
        d = torch._foreach_mul(p, self.weight_decay)
        torch._foreach_add_(d, [grads[n] for n in names])
        torch._foreach_mul_(m, self.momentum)
        torch._foreach_add_(m, d)
        torch._foreach_add_(p, torch._foreach_mul(m, -self.schedule(step)))
        if self.ema is not None:
            self.ema.update(state["ema"], params)


def make_optimizer(lr: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 1e-4, milestones=(30, 60, 90),
                   gamma: float = 0.1, steps_per_epoch: int = 1,
                   schedule: str = "multistep", max_epochs: int = 90,
                   warmup_epochs: float = 0) -> tuple[SGD, Callable]:
    """``(SGD, lr(t))``.  ``schedule``: "multistep" (the reference recipe,
    times a linear warmup when ``warmup_epochs``) or "cosine" (linear
    warmup + cosine decay over ``max_epochs``)."""
    if schedule == "multistep":
        base = multistep_lr(lr, milestones, gamma, steps_per_epoch)
        if warmup_epochs:
            warm = max(1, int(warmup_epochs * steps_per_epoch))

            def sched(t: int) -> float:
                # the ramp TIMES the multistep curve: milestones stay
                # absolute, not shifted by the warmup
                return base(t) * min(1.0, (t + 1) / warm)
        else:
            sched = base
    elif schedule == "cosine":
        sched = cosine_lr(lr, max_epochs, steps_per_epoch, warmup_epochs)
    else:
        raise ValueError(f"unknown schedule {schedule!r} "
                         "(multistep | cosine)")
    return SGD(sched, momentum, weight_decay), sched
