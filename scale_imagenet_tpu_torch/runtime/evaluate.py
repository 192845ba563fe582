"""Evaluation loop (counterpart of ``scale_imagenet_tpu/runtime/evaluate.py``,
the reference's ``test()``)."""

from __future__ import annotations

import time

import torch

from ..parallel.data_parallel import all_reduce_sums
from ..train.metrics import AverageMeter

_KEYS = ("loss", "top1", "top5", "n")
# the robust steps' extras: certified and adversarial top-1
_EXTRAS = ("cert", "adv")


def evaluate(eval_step, loader, logger=None, epoch: int = 0,
             log_interval: int = 40, verbose: bool = True,
             totals: dict | None = None, group=None):
    """Run one evaluation epoch over ``loader`` (``(images, labels)``
    batches on the step's device); returns ``(top1, top5, loss)``, and the
    averages of the step's ``cert``/``adv`` extras (weighted by ``n``, as
    the other metrics) as a fourth item when it reports them.

    With several ranks, each scoring its slice, the sums are added over
    the ranks of ``group`` at the end (a mesh's ``data_group``; None: every
    rank; ``parallel/data_parallel.py::all_reduce_sums``): the metrics
    returned are then those of the whole set (the running ones printed and
    logged at a log point stay this rank's).  Every rank must call it, in
    lockstep.  ``totals``: a dict that receives ``{"images":
    n}``, the images scored (over every rank).

    Per-batch metrics stay on the device until a log point or the end of
    the epoch, and then come to the host in one copy: a ``.item()`` per
    batch would make the host wait for the card every batch, so nothing
    queued would overlap.  The drain at each log point is the loop's
    back-pressure: it bounds the batches in flight.  Its copy waits for
    the card, so the printed ms/batch, the wall time from the end of one
    drain to the end of the next over the batches between, is the batches'
    real time in steady state.
    """
    losses = AverageMeter("Loss", ":.4e")
    top1 = AverageMeter("Acc@1", ":6.2f")
    top5 = AverageMeter("Acc@5", ":6.2f")
    extras = {k: AverageMeter(k, ":6.2f") for k in _EXTRAS}
    pending = []        # device-side metric dicts not yet folded in

    def drain():
        if not pending:
            return
        keys = _KEYS + tuple(k for k in _EXTRAS if k in pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending]).cpu().tolist()
        for row in rows:
            loss, t1, t5, n, *more = row
            n = int(n)
            losses.update(loss, n)
            top1.update(t1, n)
            top5.update(t5, n)
            for k, v in zip(keys[len(_KEYS):], more):
                extras[k].update(v, n)
        pending.clear()

    drained = time.perf_counter()
    for batch_idx, (images, labels) in enumerate(loader):
        pending.append(eval_step(images, labels))
        if batch_idx % log_interval == 0:
            batches = len(pending)
            drain()
            now = time.perf_counter()
            ms = (now - drained) * 1e3 / batches
            drained = now
            if verbose:
                print(f"eval [{batch_idx}] loss {losses.avg:.3f} "
                      f"acc1 {top1.avg:.3f}% acc5 {top5.avg:.3f}% "
                      f"({ms:.0f} ms/batch)")
            if logger is not None:
                step = epoch * 10**6 + batch_idx
                logger.add_scalar("Loss/test", losses.avg, step)
                logger.add_scalar("Accuracy/test", top1.avg, step)
    drain()
    meters = [losses, top1, top5, *extras.values()]
    sums = all_reduce_sums([v for m in meters for v in (m.sum, m.count)],
                           group)
    for m, total, count in zip(meters, sums[::2], sums[1::2]):
        m.sum, m.count = total, int(count)
        m.avg = total / max(m.count, 1)
    if totals is not None:
        totals["images"] = losses.count
    extra_avgs = {k: m.avg for k, m in extras.items() if m.count}
    if verbose:
        print(f"Acc.. {top1.avg} {top5.avg}"
              + "".join(f" {k} {v}" for k, v in extra_avgs.items()))
    if extra_avgs:
        return top1.avg, top5.avg, losses.avg, extra_avgs
    return top1.avg, top5.avg, losses.avg
