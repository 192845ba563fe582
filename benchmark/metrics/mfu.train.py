"""The whole step's share of the float32 peak in the traced stretch of
the train window: model FLOPs an image x images x 3 (forward and
backward) / wall time / 67 TFLOP/s, in %."""
from harness import readers

UNIT, LAYER, MOVES = "%", "the whole step on the card", "train_img_s"


def read(run):
    return readers.mfu(run, "train", 3)
