"""The readers' arithmetic: the device busy union, idle gaps, the
trace's window, the breakdown, the window kernels' bound, mfu, and the model FLOPs of each
configuration against ``torch.utils.flop_counter`` on the reference."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import manifest, readers, roofline
from harness.trace import MARK, breakdown, busy_ns, extent, idle_gaps


def test_busy_union_and_gaps():
    spans = [(0, 10, "a"), (5, 12, "b"), (20, 25, "a"), (21, 22, "c"),
             (30, 31, "d")]
    assert busy_ns(spans) == 12 + 5 + 1
    assert idle_gaps(spans) == [(12, 20), (25, 30)]
    assert busy_ns([]) == 0


def test_the_trace_window_holds_the_busy_union():
    mark = "at::cuda::(anonymous namespace)::" + MARK + "(long)"
    # a copy queued before the first marker, a kernel that ends past the
    # last: the window is the trace's extent, and busy lies inside it
    spans = sorted([(0, 8, "Memcpy HtoD"), (10, 11, mark), (12, 40, "k"),
                    (30, 75, "k2"), (58, 59, mark)])
    w0, w1 = extent(spans)
    assert (w0, w1) == (0, 75)
    assert busy_ns([x for x in spans if MARK not in x[2]]) == 71 <= w1 - w0
    assert extent([]) == (0, 0)


def test_breakdown_names_gaps_by_the_innermost_host_op():
    spans = [(0, 10, "k1"), (20, 30, "k2"), (32, 40, "k1")]
    hosts = [(0, 100, "loop"), (11, 19, "feed_wait"), (30, 33, "step")]
    out = breakdown(spans, hosts)
    assert out["device_ops"][0][0] == "k1"
    assert out["device_ops"][0][1] == pytest.approx(18e-9)
    gaps = dict(map(tuple, out["idle_gaps"]))
    assert gaps == pytest.approx({"feed_wait": 10e-9, "step": 2e-9})


def _run(mode, spans, seconds, steps, batch=256, flops=10 ** 9,
         launches=()):
    st = types.SimpleNamespace(spans=spans, seconds=seconds,
                               trace_s=seconds, prof=None)
    return types.SimpleNamespace(mode=mode, stretch=st, stretch_steps=steps,
                                 batch=batch, flops_per_image=flops,
                                 window_launches=list(launches),
                                 feed_wait_s=[0.001, 0.003])


def test_mfu_idle_and_shares():
    spans = [(0, int(0.5e9), "genericTranspose_kernel"),
             (int(0.5e9), int(0.8e9), "sgemm"),
             (int(0.8e9), int(0.9e9), "Memcpy HtoD")]
    run = _run("eval", spans, 1.0, 67)
    assert readers.mfu(run, "eval", 1) == pytest.approx(
        100 * 67 * 256 * 1e9 / 67e12)
    assert readers.mfu(run, "train", 3) is None
    assert readers.mfu(_run("train", spans, 1.0, 67), "train", 3) == \
        pytest.approx(3 * 100 * 67 * 256 * 1e9 / 67e12)
    assert readers.idle_share(run, "eval") == pytest.approx(10.0)
    assert readers.kernel_share(run, "eval", "genericTranspose") == \
        pytest.approx(100 * 0.5 / 0.8)
    assert readers.feed_wait_ms(run, "eval") == pytest.approx(2.0)
    assert readers.feed_wait_ms(run, "train") is None


def test_window_bound_and_roofline():
    launch = {"bytes": int(3.35e12), "ops": int(67e12)}
    assert roofline.bound_s(launch) == pytest.approx(1.0)
    launch = {"bytes": int(3.35e12), "ops": int(2 * 67e12)}
    assert roofline.bound_s(launch) == pytest.approx(2.0)
    assert roofline.table_words(16) == 2048
    assert roofline.table_words(8) == 128
    per_batch = [{"bytes": int(3.35e9), "ops": 0}] * 2     # 1 ms each
    spans = [(0, int(4e6), "lut_window_bits_kernel")] * 1 + \
        [(int(4e6), int(8e6), "lut_window_bits_kernel")]
    run = _run("eval", spans, 1.0, 1, launches=per_batch)
    assert readers.window_roofline(run, "lut_window_bits") == \
        pytest.approx(25.0)
    assert readers.window_roofline(run, "gate_cubes") is None


def test_flagship_window_launches():
    """8 launches a batch: heads 1+2 merged, head 3 and the fuse head of
    blocks 1 and 2, heads 1+2 and head 3 of block 3; each the table
    contract's bytes counted by hand for the first."""
    cfg = manifest.config("ttnet_imagenet_small")
    ref = manifest.reference("ttnet_imagenet").build(cfg["model"])
    launches = roofline.window_launches(ref, 256, 224)
    assert [x["heads"] for x in launches] == [2, 1, 1, 2, 1, 1, 2, 1]
    first = launches[0]
    e = 256 * 29 * 29                       # k4 s2 p2 over 56x56
    assert first["E"] == e
    table = 2 * 64 * 1 * 2048 * 4
    assert first["bytes"] == (256 * 64 * 56 * 56 + e * 2 * 64) * 2 + table
    assert first["ops"] == e * 64 * 2 * 16 + 2 * e * 2 * 64


@pytest.mark.parametrize("name", ["ttnet_imagenet_small",
                                  "TT_vf_19lv2_imgnet"])
def test_flops_per_image(name):
    cfg = manifest.config(name)
    ref = manifest.reference(cfg["reference"]).build(cfg["model"])
    assert sum(p.numel() for p in ref.parameters()) == cfg["params"]
    size = cfg["model"]["image_size"]
    assert roofline.model_flops(ref, size) == cfg["flops_per_image"]
    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        ref.eval()(torch.zeros(1, 3, size, size))
    assert fc.get_total_flops() == cfg["flops_per_image"]
