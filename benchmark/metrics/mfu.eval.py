"""The whole step's share of the float32 peak in the traced stretch of
the eval window: model FLOPs an image x images / wall time / 67 TFLOP/s, in %."""
from harness import readers

UNIT, LAYER, MOVES = "%", "the whole step on the card", "eval_img_s"


def read(run):
    return readers.mfu(run, "eval", 1)
