"""Where a cell's device sat idle, by what its host was doing.

    python3 benchmark/gaps.py --workload <name> --seed <n> [--seconds <s>]

From the root of a checkout, on a card.  Runs the cell once with its
traced stretch (``run.py --trace 1``'s), keeps the profiler's operations
with their launches, and prints one JSON line: the stretch's idle ms,
split by ``harness.program.attribute_gaps`` over the program's spans on
the loop's thread (each gap placed on the host's clock through the
launch of the operation that ended it), and the readings of the cell's
per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    bench.cache_env()
    sys.path[:0] = [str(bench.BENCH), str(bench.ROOT)]
    from harness import manifest, program, trace

    cell = manifest.cell(args.workload)
    bench.require_cards(cell.chips)
    import torch
    from torch.autograd import DeviceType

    from harness.cell import run_cell
    from scale_imagenet_tpu_torch.kernels import build
    from scale_imagenet_tpu_torch.utils import tracing

    build.BUILD_DIR = bench.ROOT / "build" / "kernels"
    kept: dict = {}
    stop = trace.Stretch.stop

    def keeping_stop(self):
        prof = self.prof            # stop() lets go of it
        stop(self)
        events = prof.profiler.kineto_results.events()
        kept["ops"] = sorted(
            (e.start_ns(), e.end_ns(), e.correlation_id()) for e in events
            if e.device_type() == DeviceType.CUDA and
            trace.MARK not in e.name())
        kept["launched"] = {
            e.correlation_id(): e.start_ns() for e in events
            if e.device_type() == DeviceType.CPU and e.correlation_id()
            and e.name().startswith("cu")}

    trace.Stretch.stop = keeping_stop
    torch.zeros(1, device="cuda")
    run = run_cell(cell, args.seed, args.seconds, True,
                   torch.device("cuda", 0), T_START)
    st = run.stretch
    lo, hi = min(h[0] for h in st.hosts), max(h[1] for h in st.hosts)
    spans = [s for s in tracing.spans() if lo <= s.start_ns <= hi]
    by = program.attribute_gaps(kept["ops"], kept["launched"], spans)
    line = bench.result(run, cell, torch.cuda.get_device_name(0))
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "card": bench.card_line(),
        "stretch_steps": run.stretch_steps,
        "idle_ms": sum(b - a for a, b in trace.idle_gaps(st.spans)) / 1e6,
        "idle_ms_by": dict(sorted(by.items(), key=lambda kv: -kv[1])),
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "correct": line["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
