"""Device time of cuDNN's ``genericTranspose`` kernels over all device
kernel time in the traced stretch of the eval window, in %."""
from harness import readers

UNIT, LAYER, MOVES = "%", "grouped convs: layers/conv.py via cuDNN", \
    "eval_img_s"


def read(run):
    return readers.kernel_share(run, "eval", "genericTranspose")
