"""White-box adversarial attacks, FGSM and PGD, under an L-inf ball
(counterpart of ``scale_imagenet_tpu/robust/attack.py``).

The empirical side of the interval certificate: for every image,
``certified <= adversarial <= clean`` accuracy.  The gradient is the
input's, through the straight-through surrogates that training uses; the
forward is the caller's (``forward(x, **kw) -> logits`` on NHWC images),
and ``eps``, ``lo`` and ``hi`` may be per-channel tensors, so that a
pixel-space ball maps through the input normalization
(``train/steps.py::_pixel_ball``).  A differentiated forward never takes
the fused pointwise kernel (``models/block_tt.py``), and ``frozen`` keeps
a model's parameters out of the graph, so each step pays for the input's
gradient alone.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def frozen(module: torch.nn.Module | None):
    """``module``'s parameters with ``requires_grad`` off inside the
    context, as they were after it."""
    params = [] if module is None else [
        p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _loss_grad(forward, x: torch.Tensor, labels: torch.Tensor,
               noise=None) -> torch.Tensor:
    """The gradient of the summed cross-entropy of the valid rows (labels
    >= 0) with respect to the images."""
    xi = x.detach().requires_grad_(True)
    kw = {} if noise is None else {"noise": noise}
    with torch.enable_grad():
        logp = torch.log_softmax(forward(xi, **kw), dim=-1)
        nll = -logp.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
        loss = torch.where(labels >= 0, nll, torch.zeros_like(nll)).sum()
        (g,) = torch.autograd.grad(loss, xi)
    return g


def fgsm_attack(forward, x: torch.Tensor, labels: torch.Tensor, eps,
                lo=0.0, hi=1.0, noise=None) -> torch.Tensor:
    """One signed-gradient step of size ``eps``, clipped to ``[lo, hi]``."""
    g = _loss_grad(forward, x, labels, noise)
    return _clip(x + eps * torch.sign(g), lo, hi)


def pgd_attack(forward, x: torch.Tensor, labels: torch.Tensor, eps,
               steps: int = 10, step_size=None, lo=0.0, hi=1.0,
               noise=None) -> torch.Tensor:
    """Projected gradient descent: ``steps`` signed-gradient steps of
    ``step_size`` (default ``eps / 4``), each projected back into the
    eps-ball around ``x`` intersected with ``[lo, hi]``.  It starts at
    ``x`` (no random start: deterministic for a deterministic model); step
    ``i`` of a stochastic model draws its flips from ``noise.child(i)``, as
    the JAX attack folds ``i`` into its key."""
    if step_size is None:
        step_size = eps / 4
    x_lo = _clip(x - eps, lo, float("inf"))
    x_hi = _clip(x + eps, float("-inf"), hi)
    adv = x
    for i in range(steps):
        g = _loss_grad(forward, adv, labels,
                       None if noise is None else noise.child(i))
        adv = _clip(adv + step_size * torch.sign(g), x_lo, x_hi)
    return adv
