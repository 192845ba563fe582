"""Timing and tracing (counterpart of
``scale_imagenet_tpu/utils/tracing.py``): a step timer that closes its
region with a host read, a ``torch.profiler`` trace into a directory, a
printer of a module's (or a dict's) tensor shapes and the ``PrintNorm``
tap, forward and backward.
"""

from __future__ import annotations

import contextlib
import time

import torch


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
