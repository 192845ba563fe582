"""Train and eval steps, losses, metrics, the optimizer and the on-device
augmentation (counterpart of the JAX ``train/``, its single-device part,
the robust step included; the mesh and tensor-parallel steps:
``ROADMAP.md``)."""

from .losses import accuracy_topk, cross_entropy, masked_metric_sums
from .metrics import AverageMeter, MetricsLogger
from .optim import SGD, get_ema, make_optimizer, params_ema
from .steps import TrainState, make_eval_step, make_input_pipeline, \
    make_robust_train_step, make_train_step

__all__ = ["accuracy_topk", "cross_entropy", "masked_metric_sums",
           "AverageMeter", "MetricsLogger", "SGD", "get_ema",
           "make_optimizer", "params_ema", "TrainState", "make_eval_step",
           "make_input_pipeline", "make_robust_train_step",
           "make_train_step"]
