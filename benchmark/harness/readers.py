"""Arithmetic shared by the per-layer metrics' readers
(``benchmark/metrics/<metric>.py``).  Each takes the finished ``Run`` and
returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

from . import roofline
from .trace import busy_ns, is_kernel


def feed_wait_ms(run, mode: str):
    if run.mode != mode or not run.feed_wait_s:
        return None
    return 1e3 * sum(run.feed_wait_s) / len(run.feed_wait_s)


def _stretch(run, mode: str):
    st = run.stretch
    if run.mode != mode or st is None or not st.spans or \
            run.stretch_steps == 0:
        return None
    return st


def idle_share(run, mode: str):
    st = _stretch(run, mode)
    if st is None:
        return None
    return 100.0 * (1.0 - busy_ns(st.spans) / 1e9 / st.trace_s)


def kernel_share(run, mode: str, part: str):
    """Device time of the kernels whose name holds ``part`` over all
    device kernel time in the stretch, in %."""
    st = _stretch(run, mode)
    if st is None:
        return None
    total = sum(e - s for s, e, n in st.spans if is_kernel(n))
    hit = sum(e - s for s, e, n in st.spans if part in n)
    return 100.0 * hit / total if total else None


def mfu(run, mode: str, passes: int):
    """Model float operations of the stretch's images (``passes``: 1 for a
    forward, 3 for forward and backward) over its wall time, in % of the
    float32 peak."""
    st = _stretch(run, mode)
    if st is None or not run.flops_per_image:
        return None
    flops = run.flops_per_image * passes * run.stretch_steps * run.batch
    return 100.0 * flops / st.seconds / roofline.F32_FLOPS_PER_S


def window_roofline(run, kernel: str):
    """Sum of the launches' least times over the sum of their device
    times, for the stretch's launches of ``kernel``."""
    st = run.stretch
    if st is None or not run.window_launches:
        return None
    times = [e - s for s, e, n in st.spans if kernel in n]
    if not times:
        return None
    per_batch = run.window_launches
    bound = sum(roofline.bound_s(x) for x in per_batch) / len(per_batch)
    return 100.0 * bound * len(times) / (sum(times) / 1e9)
