"""Readings that a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 4,5,6] [--seconds 4]

For each of ``--seeds`` one run of the cell (``--seconds`` of window), and
for each of ``--control`` one run whose compared outputs are the plain
reference's computed with TF32 on (the control: the nearest precision
below the configuration's float32, which has to come out as not
correct).  With ``--fault <kind>`` the program runs with that fault
planted underneath (``harness/faults.py``).  One JSON line a run: the
seed, which side, every compared number, and the window's rate.
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
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault", choices=("altered", "half", "unchanged"))
    args = p.parse_args(argv)
    bench.cache_env()
    sys.path[:0] = [str(bench.BENCH), str(bench.ROOT)]
    import contextlib

    from harness import manifest
    from harness.cell import run_cell
    from harness.faults import plant

    cell = manifest.cell(args.workload)
    bench.require_cards(cell.chips)
    import torch

    from scale_imagenet_tpu_torch.kernels import build
    build.BUILD_DIR = bench.ROOT / "build" / "kernels"
    jobs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control.split(",") if s]
    for seed, control in jobs:
        t = time.perf_counter()
        with plant(args.fault, cell) if args.fault and not control \
                else contextlib.nullcontext():
            run = run_cell(cell, seed, args.seconds, False,
                           torch.device("cuda", 0), t, tf32_control=control)
        side = "control" if control else args.fault or "program"
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side,
                          "numbers": run.numbers,
                          "rate": run.images / run.window_s,
                          "setup_s": run.setup_s,
                          "peak_bytes": run.peak_bytes,
                          "run_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
