"""Device milliseconds a training step spends in the optimizer's update
(``train/optim.py``): the median over the traced stretch's
``train.step`` spans of the program's ``train.optim`` CUDA-event time in
each."""
from harness import program

UNIT, LAYER, MOVES = "ms", "optimizer: train/optim.py", "train_img_s"


def read(run):
    return program.step_phase_ms(run, "train.optim")
