"""Device milliseconds a training step spends in the input pipeline
(``train/augment.py``'s crop, flip and jitter, and the normalisation):
the median over the traced stretch's ``train.step`` spans of the
program's ``train.prepare`` CUDA-event time in each.  It holds the
pipeline's kernels and the stream's idle while the host, back from the
pipeline's synchronising copies, launches the rest (PERF.md)."""
from harness import program

UNIT, LAYER, MOVES = "ms", "augmentation: train/augment.py", "train_img_s"


def read(run):
    return program.step_phase_ms(run, "train.prepare")
