"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repo root.  CPU tests run anywhere; tests marked ``gpu`` need a CUDA card
and skip without one (decided inside the test, never at import)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where "
                   "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def shrink(cell, **traffic):
    """``cell`` at p = 4 and a few small batches: the CPU's size.  A
    training cell checks one step there: at B = 4 the flips of a step's
    rounding part the runs' later steps faster than at the cell's size."""
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic)
    for d in (cell.config["model"], cell.config["program"]["flags"]):
        d["nfilter"], d["tfilter"] = 2, 2
    small = {"batch": 4, "images": 16, "shard_size": 8}
    if cell.traffic["mode"] == "train":
        small["checked_steps"] = 1
    cell.traffic.update({**small, **traffic})
    return cell


# the table cell, whose files are kept for the benchmark that takes it
# back (PERF.md, Open questions): its path is tested here all the same
LUT = {"name": "small.eval.lut", "config": "ttnet_imagenet_small",
       "traffic": "eval.lut", "chips": 1, "why": "the compiled tables"}


def cell(workload):
    from harness import manifest

    bench = manifest.manifest()
    bench = {**bench, "workloads": bench["workloads"] + [LUT]}
    return manifest.cell(workload, bench)


@pytest.fixture
def tiny():
    def make(workload, **traffic):
        return shrink(cell(workload), **traffic)
    return make
