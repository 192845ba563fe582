"""Timing and tracing (counterpart of
``scale_imagenet_tpu/utils/tracing.py``): a step timer that closes its
region with a host read, a ``torch.profiler`` trace into a directory, a
printer of a module's (or a dict's) tensor shapes and the ``PrintNorm``
tap, forward and backward.

Beside them, the port's own spans: ``span(name, device, **ids)`` around
the feed's producer and consumer (``data/loader.py``) and the train
step's phases (``train/steps.py``), kept in a bounded in-memory ring and
read back by ``spans()``.  A span records only while a ``torch.profiler``
session runs; with none, it costs one attribute read.  Its times are
Unix ns (``time.time_ns``), the clock of the profiler's host events
(``kineto_results.events()``' ``start_ns()``), so a span compares
directly with the trace's operations.  A span is never a
``record_function`` range: the profiler would project such a range onto
the device's timeline as an operation of its own.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class StepTimer:
    """Wall-clock step timer that waits for the device (``tracing.py:17``):
    ``stop(sync)`` reads one element of ``sync`` (a tensor, or the first
    of a dict's or a sequence's) to the host, which waits for the work
    that produced it."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None) -> float:
        if sync is not None:
            _first_tensor(sync).reshape(-1)[0].item()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def _first_tensor(tree) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    return _first_tensor(next(iter(values)))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the host and, where there is one, the
    card, written into ``log_dir`` as ``*.pt.trace.json`` (TensorBoard's
    profile plugin or a Chrome trace viewer; ``tracing.py:42``)."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@dataclasses.dataclass
class Span:
    """One recorded span: ``start_ns``/``end_ns`` on the host's Unix
    clock, the recording ``thread`` (``threading.get_ident``), the
    ``parent`` (the name of the span open around it on the same thread,
    or None), the caller's ``ids`` (``step=...``), and where the span was
    given a CUDA device, ``device_ms``: the time between its two CUDA
    events on the stream that was current at its edges, from the stream
    reaching the work queued before the span to its reaching the span's
    end: the span's kernels and the stream's idle between them, or, for
    a span that queues nothing, the time the stream sat idle waiting for
    the host to leave it."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: str | None
    ids: dict
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


class _Open:
    """A span being recorded: the context manager ``span`` returns while
    a profiler session runs."""

    __slots__ = ("recorder", "name", "device", "ids", "parent", "start",
                 "events")

    def __init__(self, recorder, name, device, ids):
        self.recorder, self.name, self.device, self.ids = \
            recorder, name, device, ids

    def __enter__(self):
        stack = self.recorder._stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = time.time_ns()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        end = time.time_ns()
        self.recorder._stack().pop()
        self.recorder._ring.append(Span(
            self.name, self.start, end, threading.get_ident(), self.parent,
            self.ids, events=self.events))
        return False


_OFF = contextlib.nullcontext()
RING = 65_536           # spans a recorder keeps, the newest


class SpanRecorder:
    """The program's spans, the newest ``RING`` of them (a ring: a long
    profiled run does not grow memory).  ``span`` records only while a
    ``torch.profiler`` session is active; the CUDA events of a span are
    resolved to ``device_ms`` by ``spans()``, never inside the loop, so
    recording adds no synchronisation."""

    def __init__(self):
        self._ring: collections.deque = collections.deque(maxlen=RING)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device: torch.device | None = None, **ids):
        """A context manager around one region of the program: ``name``,
        the ``device`` whose current stream carries the region's work (a
        CUDA device adds the span's device time), and ids such as
        ``step=ts.step``.  With no profiler session running it records
        nothing and reads no clock."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, device, ids)

    def spans(self) -> list[Span]:
        """The recorded spans, oldest first, each ``device_ms`` filled in
        (waiting for the span's last CUDA event where it has one)."""
        out = list(self._ring)
        for s in out:
            if s.events is not None:
                s.events[1].synchronize()
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        return out


# the process's recorder: the feed and the train step record into it
RECORDER = SpanRecorder()
span = RECORDER.span
spans = RECORDER.spans


def _named_tensors(tree, prefix: str = ""):
    if isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().items()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_tensors(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def print_tree_shapes(tag: str, tree):
    """Every tensor's name, shape and dtype (``tracing.py:51``, the
    ``PrintLayerSizes`` hook): a module's state dict, or a nested dict
    (names joined with ``/``, as JAX joins a pytree's keys)."""
    for name, t in _named_tensors(tree):
        dtype = str(getattr(t, "dtype", type(t).__name__))
        print(f"[{tag}] {name}: {tuple(getattr(t, 'shape', ()))} "
              f"{dtype.replace('torch.', '')}")


def _print_norm(tag: str, v: torch.Tensor) -> None:
    v = v.detach()
    n = float(v.to(torch.float32).square().sum().sqrt())
    print(f"[{tag}] shape={tuple(v.shape)} min={float(v.min()):.4g} "
          f"max={float(v.max()):.4g} norm={n:.4g}")


class _GradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tag):
        ctx.tag = tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _print_norm(f"{ctx.tag}:grad", g)
        return g, None


def tap_norm(tag: str, x: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """The ``PrintNorm`` debug hook (``tracing.py:59``): prints ``x``'s
    shape, range and L2 norm (in f32) as ``[tag] shape=... min=... max=...
    norm=...``, and with ``grad`` the same of the gradient flowing back
    through this point as ``[tag:grad]``.  Returns ``x``, so that it goes
    into an expression: ``h = tap_norm("block0", h)``.  Each print reads
    the values to the host."""
    _print_norm(tag, x)
    return _GradTap.apply(x, tag) if grad else x
