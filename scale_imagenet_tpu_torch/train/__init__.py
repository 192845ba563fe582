"""Eval steps, losses and metrics (the eval subset of the JAX ``train/``;
training comes with a later slice, ``ROADMAP.md``)."""

from .losses import accuracy_topk, cross_entropy, masked_metric_sums
from .metrics import AverageMeter, MetricsLogger
from .steps import make_eval_step, make_input_pipeline

__all__ = ["accuracy_topk", "cross_entropy", "masked_metric_sums",
           "AverageMeter", "MetricsLogger", "make_eval_step",
           "make_input_pipeline"]
