"""The traced stretch of a ``--trace 1`` run and what is read from it.

``Stretch`` profiles whole batches inside the window with
``torch.profiler`` (CPU and CUDA activity): the card is synchronised
before the profiler starts and before it stops, and a marker kernel
(``torch.cuda._sleep``'s ``spin_kernel``) is launched after each
synchronisation, so that the first and last device operations of the
trace stand at the stretch's edges.  The trace's window is read on the
trace's own clock, from its first device operation's start to its last
one's end; the device's busy time, the union of its operations' intervals
(``busy_ns``, the same arithmetic as ``chip_smoke.py``'s), lies inside it
by construction.  The profiler's device timestamps on the H100 do not
always agree with the host's clock or with CUDA events (a stretch of
4.17 s read 3.93 to 4.24 s; PERF.md), so the host's wall time of the
stretch is kept beside it for the rates (``mfu``).  An idle gap is named
by the innermost host operation that was running at its middle.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def device_spans(prof) -> list:
    """``(start_ns, end_ns, name)`` of every device event, each distinct
    one once, sorted."""
    from torch.autograd import DeviceType

    return sorted({(e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA})


def host_spans(prof) -> list:
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def busy_ns(spans: list) -> int:
    """Device busy time: the union of the (sorted) intervals."""
    total, reach = 0, None
    for start, end, _ in spans:
        lo = start if reach is None else max(start, reach)
        total += max(0, end - lo)
        reach = end if reach is None else max(reach, end)
    return total


def idle_gaps(spans: list) -> list:
    """``(start_ns, end_ns)`` of the gaps between the union's intervals."""
    gaps, reach = [], None
    for start, end, _ in spans:
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return gaps


MARK = "spin_kernel"
MARK_CYCLES = 1000


def extent(spans: list) -> tuple:
    """``(w0, w1)``: the first device operation's start and the last
    one's end (``(0, 0)`` for no operations)."""
    if not spans:
        return 0, 0
    return spans[0][0], max(e for _, e, _ in spans)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def top(pairs: dict, k: int = 10) -> list:
    return [[n, v] for n, v in sorted(pairs.items(), key=lambda kv: -kv[1])
            [:k]]


def breakdown(spans: list, hosts: list, k: int = 10,
              labelled: int = 400) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the host operation running at their middle (the ``labelled``
    longest gaps are named, then summed by name)."""
    ops: dict = {}
    for start, end, name in spans:
        ops[name] = ops.get(name, 0.0) + (end - start) / 1e9
    gaps = sorted(idle_gaps(spans), key=lambda g: g[0] - g[1])[:labelled]
    named: dict = {}
    if hosts:
        starts = np.array([h[0] for h in hosts], np.int64)
        ends = np.array([h[1] for h in hosts], np.int64)
        for lo, hi in gaps:
            mid = (lo + hi) // 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = hosts[inside[np.argmax(starts[inside])]][2] \
                if len(inside) else "(no host op)"
            named[name] = named.get(name, 0.0) + (hi - lo) / 1e9
    return {"device_ops": top(ops, k), "idle_gaps": top(named, k)}


class Stretch:
    """A profiled stretch of whole batches: ``start()`` and ``stop()`` are
    called between batches.  ``warm()`` starts and stops the profiler once
    during set-up, so that its first start does not fall in the window."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.spans = []
        self.hosts = []
        self.trace_s = 0.0       # the stretch on the trace's clock
        self.clock = {}          # the two clocks' readings, for the line

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self) -> None:
        with self._profiler():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = self._profiler()
        self.prof.start()
        torch.cuda._sleep(MARK_CYCLES)
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        raw = device_spans(self.prof)
        w0, w1 = extent(raw)
        self.trace_s = (w1 - w0) / 1e9
        self.spans = [x for x in raw if MARK not in x[2]]
        self.hosts = host_spans(self.prof)
        self.prof = None
        self.clock = {"host_s": self.seconds, "trace_s": self.trace_s,
                      "marks": len(raw) - len(self.spans)}

    @property
    def seconds(self) -> float:
        """The stretch's wall time on the host's clock."""
        return self.t1 - self.t0
