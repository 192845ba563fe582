"""Support utilities (counterpart of ``scale_imagenet_tpu/utils/``):
metrics, data iterators, image-space transforms, parameter accounting,
timing and tracing."""

from .misc import AverageMetric, LimitedDatasetIter, ReplayDatasetIter, \
    cast_floating, count_parameters, get_mean_and_std, get_sparsity_stat, \
    rgb_to_hsv
from .tracing import StepTimer, print_tree_shapes, profile_trace, tap_norm

__all__ = [
    "AverageMetric", "cast_floating", "LimitedDatasetIter",
    "ReplayDatasetIter", "count_parameters", "get_mean_and_std",
    "get_sparsity_stat", "rgb_to_hsv", "StepTimer", "profile_trace",
    "print_tree_shapes", "tap_norm",
]
