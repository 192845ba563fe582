"""On the card: each cell's control comes out not correct and the program
correct, under the cell's limits, at a size a test run holds (the full
widths, a smaller batch and image set, a short window).  The control is
the plain reference in the program's place computed with TF32 on, the
nearest precision below the configuration's float32 (TF32 off).  The
readings the limits were set from, at the cells' own sizes, come from
``benchmark/calibrate.py``."""

from __future__ import annotations

import time

import pytest

from harness import cell as hcell
from harness.correct import judge

SIZES = {"eval": {"batch": 64, "images": 256, "shard_size": 128},
         "train": {"batch": 64, "images": 256, "shard_size": 128}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [
    "small.eval.conv", "v1.eval.conv", "small.train.f32", "small.eval.lut"])
@pytest.mark.parametrize("control", [True, False])
def test_control_fails_and_program_passes(card, workload, control):
    from conftest import cell

    c = cell(workload)
    c.traffic = {**c.traffic, **SIZES[c.traffic["mode"]]}
    run = hcell.run_cell(c, 2 ** 31 + 101, 1.0, False, card,
                         time.perf_counter(), tf32_control=control)
    ok, checks = judge(run.numbers, c.limits)
    assert ok is not control, checks
