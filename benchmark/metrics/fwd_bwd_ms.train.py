"""Device milliseconds a training step spends in the model's forward,
loss and backward: the median over the traced stretch's ``train.step``
spans of the program's ``train.fwd_bwd`` CUDA-event time in each (the
grouped convs, BN and binarize kernels and their transposes)."""
from harness import program

UNIT, LAYER, MOVES = "ms", "the whole step on the card", "train_img_s"


def read(run):
    return program.step_phase_ms(run, "train.fwd_bwd")
