from .binarize import Binarize01Act, BinaryActivation, NoiseKey, \
    binarize01_act, bireal_act, dead_zone_noise, heaviside01, \
    heaviside01_noisy
from .gelu import gelu
from .poly import polynome_act
from .quantize import activation_quantize, input_quantize, ste_round, \
    uniform_quantize

__all__ = ["Binarize01Act", "BinaryActivation", "NoiseKey",
           "binarize01_act", "bireal_act", "dead_zone_noise", "heaviside01",
           "heaviside01_noisy", "gelu", "polynome_act",
           "activation_quantize", "input_quantize", "ste_round",
           "uniform_quantize"]
