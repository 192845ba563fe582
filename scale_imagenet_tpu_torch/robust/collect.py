"""The multi-sample robust forward of any registry model (counterpart of
``scale_imagenet_tpu/robust/collect.py``).

Every model reaches its Heavisides through ``binarize01_act``, which shows
its input to the innermost of ``ops.binarize.ACTIVATION_OBSERVERS``.
Inside ``stability_loss_collector(k)`` each such input of a packed
``(k N, ...)`` batch adds the ``rsloss`` between its last two sample
groups, in call order (the reference's ``MultiSampleTensor`` duck-typing in
``Binarize01Act``, netbin.py:710-724, as a collector).
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import binarize
from ..ops.binarize import rsloss
from .multisample import LOSS_LAYER_DECAY, multi_sample_pack, \
    multi_sample_unpack_natural


class _Collector:
    def __init__(self, k: int):
        self.k = k
        self.losses = []

    def record(self, x: torch.Tensor) -> None:
        kn = x.shape[0]
        if kn % self.k:
            return
        rv = x.reshape((self.k, kn // self.k) + tuple(x.shape[1:]))
        self.losses.append(rsloss(rv[-1], rv[-2]))

    def total(self) -> torch.Tensor:
        if not self.losses:
            return torch.zeros(())
        total = self.losses[0]
        for loss in self.losses[1:]:
            total = total * LOSS_LAYER_DECAY + loss
        return total


@contextlib.contextmanager
def stability_loss_collector(k: int = 3):
    c = _Collector(k)
    binarize.ACTIVATION_OBSERVERS.append(c)
    try:
        yield c
    finally:
        binarize.ACTIVATION_OBSERVERS.pop()


def multi_sample_forward(model, x: torch.Tensor, x_adv: torch.Tensor, eps,
                         key, inputs_min=0.0, inputs_max=1.0,
                         training: bool = True, return_state: bool = False):
    """``forward_with_multi_sample`` for any model on NHWC images:
    ``(logits of the x_adv group, stability loss)``, and with
    ``return_state`` the new BN running statistics of the packed ``3 N``
    forward (the ``stats`` sink of ``layers/norm.py``; ``None`` unless
    ``training``), which robust training writes instead of paying a second
    forward.  ``key`` (a ``NoiseKey``) splits as the JAX key does: its
    ``child(0)`` draws the signs, ``child(1)`` keys a stochastic model's
    coin flips."""
    k, data = multi_sample_pack(x, x_adv, eps, key.child(0), inputs_min,
                                inputs_max)
    stats = {} if training else None
    kw = {"noise": key.child(1)} \
        if getattr(model.cfg, "stochastic", False) else {}
    with stability_loss_collector(k) as c:
        logits = model(data, stats, **kw)
    nat = multi_sample_unpack_natural(logits, k)
    if return_state:
        return nat, c.total(), stats
    return nat, c.total()
