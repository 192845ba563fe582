from .bn_fold import conv_bn_pairs_ttnet_imagenet, fold_bn_into_conv, \
    fold_model_bns
from .export import save_torch_checkpoint
from .from_jax import jax_trees, state_dict_from_jax

__all__ = ["conv_bn_pairs_ttnet_imagenet", "fold_bn_into_conv",
           "fold_model_bns", "save_torch_checkpoint",
           "jax_trees", "state_dict_from_jax"]
