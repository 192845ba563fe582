"""A harness run with the timed path broken underneath comes out not
correct under the cell's limits, once for each fault the cell can have
(``harness/faults.py``): an answer altered where it is produced, half of
the batch left out, and for training a step that returns its state
unchanged.  (One card a cell: no exchange between chips to leave out.)
The look for a card is skipped: the runs are on the CPU at a small
size."""

from __future__ import annotations

import time

import pytest
import torch

from harness import cell as hcell
from harness.correct import judge
from harness.faults import plant


def _run(cell, kind):
    torch.set_num_threads(2)
    with plant(kind, cell):
        run = hcell.run_cell(cell, 2 ** 31 + 23, 0.5, False, "cpu",
                             time.perf_counter())
    return judge(run.numbers, cell.limits)


@pytest.mark.parametrize("workload", ["small.eval.conv", "v1.eval.conv",
                                      "small.eval.lut"])
@pytest.mark.parametrize("kind", ["altered", "half"])
def test_eval_fault_is_not_correct(tiny, workload, kind):
    ok, checks = _run(tiny(workload), kind)
    assert not ok, checks


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_train_fault_is_not_correct(tiny, kind):
    ok, checks = _run(tiny("small.train.f32"), kind)
    assert not ok, checks
