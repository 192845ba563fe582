from .binarize import Binarize01Act, BinaryActivation, binarize01_act, \
    bireal_act, heaviside01
from .gelu import gelu
from .poly import polynome_act

__all__ = ["Binarize01Act", "BinaryActivation", "binarize01_act",
           "bireal_act", "heaviside01", "gelu", "polynome_act"]
