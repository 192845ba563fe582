"""The port's program spans (``scale_imagenet_tpu_torch/utils/tracing.py``)
on the CPU, and the loop's printed time:

* no span is recorded, no clock read and no CUDA event made while no
  profiler runs;
* under a ``torch.profiler`` session spans nest (parent, thread, ids),
  sit on the profiler's host clock, and the ring keeps its bound;
* ``device_prefetch`` records ``feed.read``/``feed.stage`` on its
  producer's thread and ``feed.wait`` on the caller's;
* ``feed.wait`` is given the consumer's device, for its CUDA events;
* both train steps record ``train.step`` and its three phases, with no
  device time on the CPU;
* ``utils.__all__`` is the JAX package's (the new names stay out);
* ``evaluate`` prints the wall time between drains over the batches.
"""

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu_torch import utils
from scale_imagenet_tpu_torch.data import loader as loader_mod
from scale_imagenet_tpu_torch.data.loader import device_prefetch
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_robust_train_step, make_train_step
from scale_imagenet_tpu_torch.utils import tracing

# the module: ``runtime``'s package exports the function under its name
evaluate_mod = importlib.import_module(
    "scale_imagenet_tpu_torch.runtime.evaluate")

pytestmark = pytest.mark.usefixtures("few_threads")

PHASES = ("train.prepare", "train.fwd_bwd", "train.optim")


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def recorded():
    """The process's recorder's spans that start after the fixture."""
    since = time.time_ns()
    return lambda: [s for s in tracing.spans() if s.start_ns >= since]


def test_no_profiler_no_span_no_clock_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("read or made while tracing is off")

    monkeypatch.setattr(tracing.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    rec = tracing.SpanRecorder()
    with rec.span("train.step", torch.device("cuda"), step=3):
        with rec.span("train.optim", torch.device("cuda")):
            pass
    assert rec.spans() == []
    assert rec.span("x") is rec.span("y")      # one shared null context


def test_spans_nest_with_parent_thread_and_ids():
    rec = tracing.SpanRecorder()
    other: dict = {}

    def worker():
        other["thread"] = threading.get_ident()
        with rec.span("feed.read", batch=0):
            pass

    with _profiled():
        with rec.span("train.step", torch.device("cpu"), step=7):
            with rec.span("train.prepare"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
            with rec.span("train.optim", torch.device("cpu")):
                pass
    assert not t.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert set(got) == {"train.step", "train.prepare", "train.optim",
                        "feed.read"}
    step = got["train.step"]
    assert step.parent is None and step.ids == {"step": 7}
    for name in ("train.prepare", "train.optim"):
        s = got[name]
        assert s.parent == "train.step" and s.thread == step.thread
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
        assert s.device_ms is None          # a CPU device has no events
    read = got["feed.read"]
    assert read.parent is None              # another thread's stack
    assert read.thread == other["thread"] != step.thread
    assert read.ids == {"batch": 0}


def test_span_and_profiler_event_share_one_clock():
    """A span around a ``record_function`` region encloses that region's
    host event to the clocks' agreement, and within 100 us at each end."""
    from torch.autograd import DeviceType

    rec = tracing.SpanRecorder()
    reps = 9
    with _profiled() as prof:
        for i in range(reps):
            with rec.span("outer", i=i):
                with torch.profiler.record_function(f"region{i}"):
                    torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and
              e.name().startswith("region")}
    before, after = [], []
    for s in rec.spans()[2:]:               # the first calls warm up
        e = events[f"region{s.ids['i']}"]
        before.append(e.start_ns() - s.start_ns)
        after.append(s.end_ns - e.end_ns())
    for margins in (before, after):
        assert min(margins) >= -10_000      # encloses, to 10 us
        assert float(np.median(margins)) <= 100_000


def test_ring_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 4)
    rec = tracing.SpanRecorder()
    with _profiled():
        for i in range(10):
            with rec.span("s", i=i):
                pass
    assert [s.ids["i"] for s in rec.spans()] == [6, 7, 8, 9]


def test_device_prefetch_records_producer_and_consumer(recorded):
    batches = [(np.full((2, 3), k, np.uint8), np.full(2, k, np.int32))
               for k in range(3)]
    with _profiled():
        got = [int(x[0, 0]) for x, _ in device_prefetch(iter(batches),
                                                        "cpu")]
    assert got == [0, 1, 2]
    spans = recorded()
    by = {n: [s for s in spans if s.name == n]
          for n in ("feed.read", "feed.stage", "feed.wait")}
    # the read that finds the end, and the wait that receives it, count
    assert [s.ids["batch"] for s in by["feed.read"]] == [0, 1, 2, 3]
    assert [s.ids["batch"] for s in by["feed.stage"]] == [0, 1, 2]
    assert [s.ids["batch"] for s in by["feed.wait"]] == [0, 1, 2, 3]
    producer = {s.thread for s in by["feed.read"] + by["feed.stage"]}
    assert len(producer) == 1
    assert {s.thread for s in by["feed.wait"]} == {threading.get_ident()}
    assert producer != {threading.get_ident()}
    assert all(s.parent is None for s in spans)


def test_feed_wait_gets_the_consumer_device(monkeypatch):
    """Only the consumer's wait carries the device (its CUDA events time
    the stream's idle for the feed); the producer's spans are host
    time."""
    given: dict = {}

    def span(name, device=None, **ids):
        given.setdefault(name, set()).add(device)
        return tracing.span(name, device, **ids)

    monkeypatch.setattr(loader_mod, "span", span)
    dev = torch.device("cpu")
    batches = [(np.zeros((2, 3), np.uint8), np.zeros(2, np.int32))] * 2
    assert len(list(device_prefetch(iter(batches), dev))) == 2
    assert given == {"feed.read": {None}, "feed.stage": {None},
                     "feed.wait": {dev}}


def _step_spans(spans):
    steps = [s for s in spans if s.name == "train.step"]
    phases = {p: [s for s in spans if s.name == p] for p in PHASES}
    return steps, phases


@pytest.mark.parametrize("kind", ["plain", "accum2", "robust"])
def test_train_steps_record_the_step_and_its_phases(recorded, kind):
    md = get_model("cifar10lownoise") if kind == "robust" else get_model(
        "ttnet_imagenet_xsmall", nfilter=2, tfilter=2, layers=0,
        image_size=32)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.arange(4, dtype=torch.int64) % md.config.num_classes
    model = md.init(device="cpu")
    opt, _ = make_optimizer(lr=0.1, milestones=(1,), steps_per_epoch=1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    if kind == "robust":
        step = make_robust_train_step(md, model, opt, eps=0.0, coeff=0.0)
    else:
        step = make_train_step(model, opt,
                               accum=2 if kind == "accum2" else 1)
    ts, _ = step(ts, x, y)                  # unprofiled: records nothing
    assert recorded() == []
    with _profiled():
        for _ in range(2):
            ts, _ = step(ts, x, y)
    steps, phases = _step_spans(recorded())
    assert [s.ids for s in steps] == [{"step": 1}, {"step": 2}]
    micro = 2 if kind == "accum2" else 1
    for name, found in phases.items():
        per_step = micro if name in ("train.prepare", "train.fwd_bwd") \
            else 1
        assert len(found) == 2 * per_step, name
        for s in found:
            assert s.parent == "train.step" and s.device_ms is None
            assert any(t.start_ns <= s.start_ns <= s.end_ns <= t.end_ns
                       for t in steps)
    assert all(s.device_ms is None for s in steps)
    # in order inside a step: input, forward and backward, update
    first = [phases[p][0] for p in PHASES]
    assert all(a.end_ns <= b.start_ns for a, b in zip(first, first[1:]))


def test_utils_all_keeps_the_jax_package_names():
    assert sorted(utils.__all__) == sorted([
        "AverageMetric", "cast_floating", "LimitedDatasetIter",
        "ReplayDatasetIter", "count_parameters", "get_mean_and_std",
        "get_sparsity_stat", "rgb_to_hsv", "StepTimer", "profile_trace",
        "print_tree_shapes", "tap_norm"])
    assert not {"span", "spans", "SpanRecorder"} & set(utils.__all__)


def test_evaluate_prints_the_time_between_drains(monkeypatch, capsys):
    """The step returns at once (1 ms to queue); the drain's copy waits
    80 ms a batch for the card: the printed ms/batch is the batches' 81,
    not the enqueue's 1."""
    clock = types.SimpleNamespace(t=100.0)
    monkeypatch.setattr(evaluate_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock.t))
    real_cpu = torch.Tensor.cpu

    def waiting_cpu(self, *a, **k):
        clock.t += 0.080 * self.shape[0]    # one row a pending batch
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", waiting_cpu)

    def step(images, labels):
        clock.t += 0.001
        one = torch.ones(())
        return {"loss": one, "top1": one * 100, "top5": one * 100,
                "n": one * len(labels)}

    loader = [(torch.zeros(2, 1), torch.zeros(2)) for _ in range(9)]
    top1, _, _ = evaluate_mod.evaluate(step, loader, log_interval=4)
    assert top1 == pytest.approx(100.0)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("eval [")]
    assert [ln.split("(")[-1] for ln in lines] == ["81 ms/batch)"] * 3


def test_profile_trace_still_records_spans(tmp_path, recorded):
    """``profile_trace`` is a profiler session: spans inside it record."""
    with tracing.profile_trace(str(tmp_path)):
        with tracing.span("feed.wait", batch=0):
            pass
    assert [s.name for s in recorded()] == ["feed.wait"]
