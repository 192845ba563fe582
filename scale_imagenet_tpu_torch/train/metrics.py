"""Metric aggregation and structured logging (counterpart of
``scale_imagenet_tpu/train/metrics.py``): ``AverageMeter`` as the
reference's, and a scalar logger that writes JSONL always and TensorBoard
when ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import os
import time


class AverageMeter:
    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class MetricsLogger:
    """Scalar logger: ``<log_dir>/metrics.jsonl`` always; TensorBoard
    event files too when the ``tensorboard`` package is installed."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
