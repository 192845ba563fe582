from .conv import BinConv2d, bias_from_bin_weight_conv, bin_conv2d, conv2d
from .linear import BinLinear, bias_from_bin_weight, bin_linear, linear
from .norm import BN_OBSERVERS, ScaleBias, StatsBN, batch_norm, \
    bn_scale_bias, scale_bias_layer, stats_bn
from .pool import avg_pool, constant_pad2d, flatten, max_pool, zero_pad2d

__all__ = ["BinConv2d", "bias_from_bin_weight_conv", "bin_conv2d", "conv2d",
           "BinLinear", "bias_from_bin_weight", "bin_linear", "linear",
           "BN_OBSERVERS", "ScaleBias", "StatsBN", "batch_norm",
           "bn_scale_bias", "scale_bias_layer", "stats_bn", "avg_pool",
           "constant_pad2d", "flatten", "max_pool", "zero_pad2d"]
