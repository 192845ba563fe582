from .lut_eval import compile_ttnet_lut, lut_ttnet_apply, lut_ttnet_features
from .lut_store import LUT_FORMAT_VERSION, load_luts, params_digest, \
    save_luts
from .truth_table import block_truth_table, enumerate_patterns

__all__ = ["compile_ttnet_lut", "lut_ttnet_apply", "lut_ttnet_features",
           "LUT_FORMAT_VERSION", "load_luts", "params_digest", "save_luts",
           "block_truth_table", "enumerate_patterns"]
