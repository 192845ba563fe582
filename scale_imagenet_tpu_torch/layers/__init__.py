from .conv import conv2d
from .linear import linear
from .norm import batch_norm, bn_scale_bias
from .pool import avg_pool, constant_pad2d, flatten, max_pool, zero_pad2d

__all__ = ["conv2d", "linear", "batch_norm", "bn_scale_bias", "avg_pool",
           "constant_pad2d", "flatten", "max_pool", "zero_pad2d"]
