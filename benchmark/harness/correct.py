"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference on the same inputs.

Eval cells compare the logits the window's forward produced for a sample
of its batches (drawn from the seed) with the reference's logits of the
same images.  A Heaviside turns an ulp near its threshold into a flipped
bit, so the two float32 forwards, which sum in other orders, part by a
little: the number compared is ``logit_gap``, the mean over the sampled
images of an image's logit gap ``|l - r|_2`` over the spread of the
reference's logits across those images, ``sqrt(mean |r - mean(r)|_2^2)``:
the part of the answer that depends on the image (with random weights
most of a logit vector is the same for every image: 99.4 % of its norm
for the flagship, 99.995 % for v1).  The largest image's gap and the
share of images whose top class differs are reported beside it and not
compared.

The training cell compares the first ``checked`` steps (the window's own
call and feed, in set-up) with the reference's steps from the same
weights, rows and augmentation draws.  A Heaviside turns the first step's
rounding into flipped bits, and the flips into different updates, so the
two runs part further at every step: the numbers compared are the first
step's loss (``loss_gap``, relative), the first step's gradient as the
optimizer gets it (its momentum after one step) by the worst leaf
(``grad_gap``), and the parameters' and the BN running statistics' change
after the checked steps by the median leaf (``change_gap``, ``bn_gap``).
A leaf's gap is that between the program's norm and the reference's, over
the reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of ``grad_gap`` and ``change_gap``: they move
by round-off alone.  The later steps' loss gaps and the worst leaves'
changes are reported beside them and not compared.
"""

from __future__ import annotations

import torch

INF = float("inf")


def eval_numbers(got: dict, want: dict) -> dict:
    """``got``/``want``: batch index -> (B, classes) logits on the CPU."""
    for i, r in want.items():
        g = got.get(i)
        if g is None or g.shape != r.shape or not torch.isfinite(g).all():
            return {"logit_gap": INF, "logit_gap_max": INF,
                    "argmax_flip_share": 1.0}
    g = torch.cat([got[i] for i in want]).double()
    r = torch.cat(list(want.values())).double()
    spread = (r - r.mean(0)).square().sum(1).mean().sqrt().clamp(min=1e-30)
    gaps = (g - r).norm(dim=1) / spread
    return {"logit_gap": float(gaps.mean()),
            "logit_gap_max": float(gaps.max()),
            "argmax_flip_share": float((g.argmax(1) != r.argmax(1))
                                       .double().mean())}


def _gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap of norms (inf where the program lacks the leaf or
    reads NaN)."""
    norms = {n: float(want[n].double().norm()) for n in names}
    med = float(torch.tensor(sorted(norms.values())).median()) \
        if norms else 0.0
    gaps = {}
    for n in names:
        g = float(got[n].double().norm()) if n in got else INF
        gap = abs(g - norms[n]) / max(norms[n], med, 1e-30)
        gaps[n] = gap if gap == gap else INF
    return gaps


def _worst(gaps: dict) -> tuple:
    if not gaps:
        return 0.0, None
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def _median(gaps: dict) -> float:
    if not gaps:
        return INF
    return float(torch.tensor(sorted(gaps.values()),
                              dtype=torch.float64).median())


def train_numbers(got: dict, want: dict, p0: dict) -> dict:
    """``got``/``want``: ``loss`` (list), ``momentum``, ``params``, ``bn``
    (name -> tensor), and ``want["grad_norm"]`` the reference's raw first
    gradient norms; ``p0`` the weights both started from."""
    loss = [abs(float(g) - float(w)) / abs(float(w))
            for g, w in zip(got["loss"], want["loss"])]
    if len(got["loss"]) != len(want["loss"]) or not loss:
        loss = [INF] * max(len(want["loss"]), 1)
    loss = [v if v == v else INF for v in loss]
    gn = {n: float(v) for n, v in want["grad_norm"].items()}
    med = float(torch.tensor(sorted(gn.values())).median())
    moved = [n for n, v in gn.items() if v >= 1e-3 * med]
    grad, grad_leaf = _worst(_gaps(got["momentum"], want["momentum"],
                                   moved))
    change = _gaps(
        {n: got["params"][n] - p0[n] for n in moved if n in got["params"]},
        {n: want["params"][n] - p0[n] for n in moved}, moved)
    bn = _gaps({n: got["bn"][n] - p0[n] for n in want["bn"]
                if n in got["bn"]},
               {n: want["bn"][n] - p0[n] for n in want["bn"]},
               list(want["bn"]))
    return {"loss_gap": loss[0], "grad_gap": grad,
            "change_gap": _median(change), "bn_gap": _median(bn),
            "loss_gap_later": max(loss[1:], default=0.0),
            "change_gap_worst": _worst(change)[0],
            "bn_gap_worst": _worst(bn)[0],
            "left_out": len(gn) - len(moved),
            "worst": {"grad": grad_leaf, "change": _worst(change)[1],
                      "bn": _worst(bn)[1]}}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limited number at or under its limit;
    ``checks`` maps each to ``{"value", "limit"}``."""
    checks = {k: {"value": numbers.get(k, INF), "limit": v}
              for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
