"""The program's own spans in the traced stretch, and the arithmetic of
the per-layer metrics that read them (``benchmark/metrics/``).

The port records spans (``scale_imagenet_tpu_torch/utils/tracing.py``)
only while a profiler runs.  A reader takes the spans whose start lies in
the stretch's host extent, the first host event's start to the last
one's end: host times against host times.  No reader places a span on
the trace's device clock: the profiler's device timestamps may stray
from the host's by tens of ms over a stretch (PERF.md), more than the
gaps a span would be held against.  Device time comes from the spans'
own CUDA events instead.  A program that records no spans (one older
than the recorder) gives every reader None.

``attribute_gaps`` is the exception, for ``benchmark/gaps.py``: it places
each idle gap on the host's clock through the launch of the operation
that ended it, which the profiler records on the host's clock too.
"""

from __future__ import annotations

import statistics

from .trace import idle_gaps

FEED_WORK = ("feed.read", "feed.stage")
LOOP = ("train.step", "feed.wait")      # spans only the loop's thread opens


def recorded(run, mode: str):
    """The program's spans that started in ``run``'s traced stretch, or
    None: another mode's run, no stretch, or no recorder in the program."""
    st = run.stretch
    if run.mode != mode or st is None or not st.hosts or \
            run.stretch_steps == 0:
        return None
    from scale_imagenet_tpu_torch.utils import tracing

    read = getattr(tracing, "spans", None)
    if read is None:
        return None
    lo = min(h[0] for h in st.hosts)
    hi = max(h[1] for h in st.hosts)
    return [s for s in read() if lo <= s.start_ns <= hi]


def per_step_device_ms(spans: list, phase: str):
    """The median over the ``train.step`` spans of the device ms of the
    ``phase`` spans inside each (its microbatches summed): a step's
    phase, robust to the one step an epoch that starts with the device
    idle."""
    per_step = []
    for step in (s for s in spans if s.name == "train.step"):
        times = [s.device_ms for s in spans if s.name == phase and
                 s.thread == step.thread and
                 step.start_ns <= s.start_ns <= step.end_ns]
        if not times or None in times:
            return None
        per_step.append(sum(times))
    return statistics.median(per_step) if per_step else None


def feed_busy_ms(spans: list):
    """The feed's producer ms in ``feed.read`` and ``feed.stage`` over the
    batches it staged."""
    staged = sum(s.name == "feed.stage" for s in spans)
    if not staged:
        return None
    busy = sum(s.end_ns - s.start_ns for s in spans if s.name in FEED_WORK)
    return busy / 1e6 / staged


def feed_idle_share(spans: list, gaps: list):
    """The loop's stream's idle while the loop waited for the feed (the
    ``feed.wait`` spans' device ms) over the device's idle time
    (``gaps``, ns), in %; None where the device was never idle or the
    waits carry no device time."""
    idle = sum(hi - lo for lo, hi in gaps)
    waits = [s.device_ms for s in spans if s.name == "feed.wait"]
    if idle <= 0 or not waits or None in waits:
        return None
    return 100.0 * sum(waits) * 1e6 / idle


def attribute_gaps(ops: list, launched: dict, spans: list,
                   host_bound_ns: int = 100_000) -> dict:
    """Idle ms of the device by what the host was doing.  ``ops``: sorted
    ``(start_ns, end_ns, correlation)`` of the device's operations;
    ``launched``: correlation -> the host ns its launch began; ``spans``:
    the program's.  A gap whose next operation started within
    ``host_bound_ns`` of its launch waited for the host: it is placed on
    the host's clock through that launch and split over the loop
    thread's innermost spans open then (``(between spans)`` where none
    is).  Any other gap had work queued (``(work queued)``)."""
    loop = {s.thread for s in spans if s.name in LOOP}
    mine = [s for s in spans if s.thread in loop]
    out: dict = {}

    def add(name, ns):
        if ns > 0:
            out[name] = out.get(name, 0.0) + ns / 1e6

    nxt = {start: corr for start, _, corr in ops}
    for g0, g1 in idle_gaps([(s, e, "") for s, e, _ in ops]):
        launch = launched.get(nxt[g1])
        if launch is None or g1 - launch > host_bound_ns:
            add("(work queued)", g1 - g0)
            continue
        lo, hi = g0 - (g1 - launch), launch      # the gap on the host's clock
        cuts = sorted({lo, hi} | {t for s in mine for t in
                                  (s.start_ns, s.end_ns) if lo < t < hi})
        for a, b in zip(cuts, cuts[1:]):
            open_ = [s for s in mine if s.start_ns <= a and s.end_ns >= b]
            add(max(open_, key=lambda s: s.start_ns).name if open_
                else "(between spans)", b - a)
    return out


# ------------------------------------------------------------ the readers

def step_phase_ms(run, phase: str):
    spans = recorded(run, "train")
    return None if spans is None else per_step_device_ms(spans, phase)


def feed_busy(run, mode: str):
    spans = recorded(run, mode)
    return None if spans is None else feed_busy_ms(spans)


def feed_idle(run, mode: str):
    spans = recorded(run, mode)
    return None if spans is None else \
        feed_idle_share(spans, idle_gaps(run.stretch.spans))
