"""The window kernels' share of their roofline in the traced stretch:
the launches' least times (the table contract's bytes at 3.35 TB/s or
its operations at 67 TFLOP/s, from the launch shapes) over the device
time of the ``lut_window_bits`` launches, in %."""
from harness import readers

UNIT, LAYER, MOVES = "%", "window kernels: csrc/lut_gather.cu", \
    "eval_img_s"


def read(run):
    return readers.window_roofline(run, "lut_window_bits")
