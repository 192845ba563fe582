"""Device time of cuDNN's ``genericTranspose`` kernels over all device
kernel time in the traced stretch of the train window, in %."""
from harness import readers

UNIT, LAYER, MOVES = "%", "grouped convs: layers/conv.py via cuDNN", \
    "train_img_s"


def read(run):
    return readers.kernel_share(run, "train", "genericTranspose")
