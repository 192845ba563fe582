"""1 - (union of the device's operation intervals) / wall time of the
traced stretch of the train window, in %."""
from harness import readers

UNIT, LAYER, MOVES = "%", "the card", "train_img_s"


def read(run):
    return readers.idle_share(run, "train")
