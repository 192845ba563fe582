"""The plain references against the program at a small size on the CPU:
the forwards of both families in float64, and whole harness runs of each
cell (window, comparison) that come out correct under the cell's limits."""

from __future__ import annotations

import time

import pytest
import torch

from harness import cell as hcell
from harness import manifest, weights
from harness.correct import judge


@pytest.mark.parametrize("name", ["ttnet_imagenet_small",
                                  "TT_vf_19lv2_imgnet"])
def test_reference_forward_equals_the_program(name):
    from conftest import shrink

    cfg = shrink(manifest.cell("small.eval.conv")).config \
        if name == "ttnet_imagenet_small" else \
        shrink(manifest.cell("v1.eval.conv")).config
    ref = weights.fill(manifest.reference(cfg["reference"]).build(
        cfg["model"]).to_empty(device="cpu"), 7, 224)
    model = hcell._program_model(cfg, ref.state_dict(), "cpu").double()
    ref = ref.double()
    x = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(1),
                   dtype=torch.float64) * 4 - 2
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2))
        got = hcell._entry(cfg["program"]["conv"])(model, x)
    assert got.shape == want.shape == (2, 1000)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-9 * float(want.abs().max()))


@pytest.mark.parametrize("workload", [
    "small.eval.conv", "v1.eval.conv", "small.eval.lut", "small.train.f32"])
def test_harness_run_is_correct(tiny, workload):
    torch.set_num_threads(2)
    c = tiny(workload)
    run = hcell.run_cell(c, 2 ** 31 + 11, 1.0, False, "cpu",
                         time.perf_counter())
    ok, checks = judge(run.numbers, c.limits)
    assert ok, checks
    assert run.steps > 0 and run.window_s >= 1.0
    assert len(run.feed_wait_s) == run.steps
