"""The readers of the program's spans (``harness/program.py``): their
arithmetic on synthetic spans (a step's median device time of a phase,
the feed's busy time a batch, the waits' device time over the idle), the
gaps placed by their launches (``benchmark/gaps.py``), the stretch's host
extent as the filter, None where there is nothing to read, and the
readers on spans the program really records under a CPU profiler."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from harness import manifest, program

NEW = ("augment_ms.train", "optim_ms.train", "feed_busy_ms.eval",
       "feed_busy_ms.train", "feed_idle_share.eval", "feed_idle_share.train",
       "fwd_bwd_ms.train")


def _span(name, start, end, device_ms=None, thread=1):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 device_ms=device_ms, thread=thread,
                                 parent=None, ids={})


def _run(mode, device, hosts, steps=2):
    st = types.SimpleNamespace(spans=device, hosts=hosts, prof=None)
    return types.SimpleNamespace(mode=mode, stretch=st, stretch_steps=steps)


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder replaced by a list the test fills."""
    from scale_imagenet_tpu_torch.utils import tracing

    spans: list = []
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    return spans


def test_per_step_device_ms_is_the_median_step():
    spans = [_span("train.step", 0, 100, 90.0),
             _span("train.prepare", 1, 5, 3.0),
             _span("train.prepare", 6, 9, 2.0),     # a second microbatch
             _span("train.optim", 80, 90, 1.5),
             _span("train.step", 100, 200, 90.0),
             _span("train.prepare", 101, 105, 4.0),
             _span("train.optim", 180, 190, 0.5),
             _span("train.step", 200, 300, 90.0),
             _span("train.prepare", 201, 205, 40.0),  # the epoch's first
             _span("train.optim", 280, 290, 0.7),
             _span("train.optim", 150, 160, 99.0, thread=2)]  # not the loop
    assert program.per_step_device_ms(spans, "train.prepare") == 5.0
    assert program.per_step_device_ms(spans, "train.optim") == 0.7
    # no steps, a step without the phase, or a phase without device time:
    # nothing to read
    assert program.per_step_device_ms(spans[1:4], "train.optim") is None
    assert program.per_step_device_ms(spans[:1], "train.optim") is None
    assert program.per_step_device_ms(
        [spans[0], _span("train.optim", 1, 2)], "train.optim") is None


def test_feed_busy_ms_is_read_and_stage_over_staged_batches():
    ms = 1_000_000
    spans = [_span("feed.read", 0, 3 * ms), _span("feed.stage", 3 * ms,
                                                  4 * ms),
             _span("feed.read", 5 * ms, 10 * ms),
             _span("feed.stage", 10 * ms, 12 * ms),
             _span("feed.read", 12 * ms, 12 * ms + 1),   # the end's read
             _span("feed.wait", 0, 50 * ms, thread=2)]
    assert program.feed_busy_ms(spans) == pytest.approx(
        (11 * ms + 1) / 1e6 / 2)
    assert program.feed_busy_ms(spans[-1:]) is None


def test_feed_idle_share_is_the_waits_device_time_over_idle():
    ms = 1_000_000
    spans = [_span("feed.wait", 5, 25, 0.5, thread=2),
             _span("feed.wait", 30, 99, 1.5, thread=2),
             _span("feed.read", 0, 100),            # the producer's
             _span("train.step", 0, 100, 90.0)]
    gaps = [(0, 6 * ms), (20 * ms, 22 * ms)]       # 8 ms idle
    assert program.feed_idle_share(spans, gaps) == pytest.approx(25.0)
    # no idle, no wait, or a wait without device time: nothing to read
    assert program.feed_idle_share(spans, []) is None
    assert program.feed_idle_share(spans[2:], gaps) is None
    assert program.feed_idle_share(
        [_span("feed.wait", 5, 25, thread=2)], gaps) is None


def test_attribute_gaps_places_each_gap_by_its_launch():
    us = 1_000
    ops = [(0, 100 * us, 1), (150 * us, 200 * us, 2),   # host-bound gap
           (201 * us, 300 * us, 3),                     # queued bubble
           (1300 * us, 1400 * us, 4)]                   # host-bound gap
    # op 2 launched 10 us before it started: its 50 us gap is host
    # 90-140 us; op 3 launched long before: queued; op 4 launched at
    # 1290 us: its 1000 us gap is host 290-1290 us
    launched = {1: 0, 2: 140 * us, 3: 10 * us, 4: 1290 * us}
    spans = [_span("train.step", 0, 2000 * us),
             _span("train.prepare", 120 * us, 400 * us),
             _span("feed.wait", 900 * us, 1000 * us),
             _span("feed.read", 0, 2000 * us, thread=2)]  # the producer
    got = program.attribute_gaps(ops, launched, spans)
    assert got == pytest.approx({
        "train.step": 0.030 + 0.500 + 0.290, "train.prepare": 0.020 + 0.110,
        "feed.wait": 0.100, "(work queued)": 0.001})
    # with no loop spans the host-bound time falls between spans
    got = program.attribute_gaps(ops, launched, spans[-1:])
    assert got == pytest.approx({"(between spans)": 1.050,
                                 "(work queued)": 0.001})


def test_readers_take_the_stretch_host_extent(recorded):
    # device: busy 0-10, idle 10-30, busy 30-40 ms; the host saw 0-40 ms
    ms = 1_000_000
    device = [(0, 10 * ms, "k"), (30 * ms, 40 * ms, "k")]
    hosts = [(0, 40 * ms, "loop"), (2 * ms, 3 * ms, "aten::add")]
    recorded += [
        _span("feed.wait", -50, -1, 9.0),              # before the stretch
        _span("train.step", -100, -1, 9.0),
        _span("train.optim", -20, -10, 7.0),
        _span("feed.wait", 10 * ms, 20 * ms, 5.0),
        _span("feed.read", 1 * ms, 4 * ms), _span("feed.stage", 4 * ms,
                                                  6 * ms),
        _span("train.step", 0, 40 * ms, 40.0),
        _span("train.prepare", 1 * ms, 2 * ms, 2.0),
        _span("train.fwd_bwd", 2 * ms, 30 * ms, 30.0),
        _span("train.optim", 35 * ms, 38 * ms, 3.0),
        _span("feed.wait", 41 * ms, 60 * ms, 9.0)]     # after it
    run = _run("train", device, hosts)
    assert program.step_phase_ms(run, "train.prepare") == 2.0
    assert program.step_phase_ms(run, "train.fwd_bwd") == 30.0
    assert program.step_phase_ms(run, "train.optim") == 3.0
    assert program.feed_busy(run, "train") == pytest.approx(5.0)
    assert program.feed_idle(run, "train") == pytest.approx(25.0)
    # another mode's readers read nothing here
    assert program.feed_busy(run, "eval") is None
    assert program.step_phase_ms(_run("eval", device, hosts),
                                 "train.optim") is None
    # no idle time on the device: no share
    assert program.feed_idle(_run("train", [(0, 40, "k")], hosts),
                             "train") is None


def test_readers_read_nothing_without_a_stretch_or_a_recorder(
        recorded, monkeypatch):
    from scale_imagenet_tpu_torch.utils import tracing

    recorded.append(_span("feed.stage", 1, 2))
    hosts = [(0, 40, "loop")]
    assert program.feed_busy(_run("eval", [], hosts), "eval") == 1e-6
    assert program.feed_busy(_run("eval", [], hosts, steps=0),
                             "eval") is None
    no_stretch = types.SimpleNamespace(mode="eval", stretch=None,
                                       stretch_steps=0)
    assert program.feed_busy(no_stretch, "eval") is None
    # a program older than the recorder: every reader gives None
    monkeypatch.delattr(tracing, "spans")
    assert program.feed_busy(_run("eval", [], hosts), "eval") is None
    assert program.step_phase_ms(_run("train", [], hosts),
                                 "train.prepare") is None


def test_new_metrics_in_the_manifest_read_program_spans():
    bench = manifest.manifest()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        entry = entries[name]
        assert entry["source"] == "program_span"
        mod = manifest.reader(name)
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            entry["unit"], entry["layer"], entry["moves"])
    assert list(entries)[-len(NEW):] == list(NEW)    # appended, in order


def test_readers_on_spans_the_program_records():
    """The feed and a train step on the CPU under a profiler, the
    stretch's host events from the same profiler: the feed's busy time
    is read; the readers of device time read nothing on the CPU."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scale_imagenet_tpu_torch.data.loader import device_prefetch
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    md = get_model("ttnet_imagenet_xsmall", nfilter=2, tfilter=2, layers=0,
                   image_size=32)
    model = md.init(device="cpu")
    opt, _ = make_optimizer(lr=0.1, milestones=(1,), steps_per_epoch=1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    batches = [(np.zeros((2, 32, 32, 3), np.float32),
                np.zeros(2, np.int64))] * 3
    time.sleep(0.001)       # the earlier tests' spans start before it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(1)      # host events at the edges, as the stretch's
        for x, y in device_prefetch(iter(batches), "cpu"):
            ts, _ = step(ts, x, y)
        torch.zeros(1)
    hosts = [(e.start_ns(), e.end_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU]
    lo, hi = min(h[0] for h in hosts), max(h[1] for h in hosts)
    run = _run("train", [(lo - 2, lo - 1, "k"), (hi + 1, hi + 2, "k")],
               hosts, steps=3)
    spans = program.recorded(run, "train")
    assert [s.name for s in spans].count("train.step") == 3
    assert [s.name for s in spans].count("feed.stage") == 3
    busy = program.feed_busy(run, "train")
    assert busy is not None and busy > 0
    assert program.feed_idle(run, "train") is None
    for phase in ("train.prepare", "train.fwd_bwd", "train.optim"):
        assert program.step_phase_ms(run, phase) is None
