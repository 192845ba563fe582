from .binarize import ACTIVATION_OBSERVERS, Binarize01Act, \
    BinaryActivation, NoiseKey, binarize01_act, bireal_act, \
    dead_zone_noise, heaviside01, heaviside01_noisy, rsloss
from .gelu import gelu
from .poly import polynome_act
from .quantize import activation_quantize, input_quantize, ste_round, \
    uniform_quantize

__all__ = ["ACTIVATION_OBSERVERS", "Binarize01Act", "BinaryActivation",
           "NoiseKey", "binarize01_act", "bireal_act", "dead_zone_noise",
           "heaviside01", "heaviside01_noisy", "rsloss", "gelu",
           "polynome_act",
           "activation_quantize", "input_quantize", "ste_round",
           "uniform_quantize"]
