"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix,
limits and per-layer readers come from ``BENCHMARK.json`` and the files it
names under ``benchmark/`` (``harness/manifest.py``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error.  The run needs as many CUDA cards
as the cell asks for and exits non-zero, printing no result, without
them, or if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``scale_imagenet_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "scale_imagenet_tpu")


def cache_env() -> None:
    """Every build and kernel cache at a fixed directory of the checkout;
    no library may pull in JAX by itself."""
    build = ROOT / "build"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark measures the card and does "
                 "not fall back to the CPU")
    if torch.cuda.device_count() < n:
        sys.exit(f"the cell needs {n} CUDA devices, "
                 f"{torch.cuda.device_count()} visible")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def end_to_end(run) -> dict:
    from harness.roofline import GIB

    rate = run.images / run.window_s
    return {"eval_img_s": rate if run.mode == "eval" else None,
            "train_img_s": rate if run.mode == "train" else None,
            "peak_mem_gib": run.peak_bytes / GIB,
            "setup_s": run.setup_s}


def result(run, cell, device: str) -> dict:
    from harness.correct import judge

    correct, checks = judge(run.numbers, cell.limits)
    metrics = {}
    if run.trace:
        for entry, mod in cell.per_layer:
            if mod.UNIT != entry["unit"] or mod.MOVES != entry["moves"]:
                raise ValueError(f"metrics/{entry['name']}.py says "
                                 f"{mod.UNIT}/{mod.MOVES}, BENCHMARK.json "
                                 f"{entry['unit']}/{entry['moves']}")
            value = mod.read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        values = end_to_end(run)
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}
    dev = {"platform": "gpu", "kind": device, "count": cell.chips,
           "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": run.images,
           "failed": sum(c["value"] > c["limit"] for c in checks.values()),
           "metrics": metrics, "device": dev}
    if run.trace:
        from harness.trace import breakdown, busy_ns

        st = run.stretch
        dev["busy_s"] = busy_ns(st.spans) / 1e9
        dev["window_s"] = st.trace_s
        out["breakdown"] = breakdown(st.spans, st.hosts)
    out["checks"] = checks
    return out


def plain(value):
    """``value`` with every non-finite float as its text: JSON has no
    infinity."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, float) and value != value or value in (
            float("inf"), float("-inf")):
        return str(value)
    return value


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness import manifest

    cell = manifest.cell(args.workload)
    require_cards(cell.chips)
    import torch
    from harness.cell import run_cell
    from scale_imagenet_tpu_torch.kernels import build

    torch.zeros(1, device="cuda")
    before = time.perf_counter() - T_START      # imports and the context

    build.BUILD_DIR = ROOT / "build" / "kernels"
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        sys.exit(f"loaded in this process: {', '.join(found)}")
    out = result(run, cell, torch.cuda.get_device_name(0))
    out["device"]["power_limit"] = card.split(",")[-1].strip()
    out["setup_phases"] = {"start": before, **run.phases}
    print("setup phases (s): " + json.dumps(out["setup_phases"]),
          file=sys.stderr)
    if run.trace:
        out["stretch"] = run.stretch.clock
        print("stretch clock: " + json.dumps(out["stretch"]),
              file=sys.stderr)
    line = {k: v for k, v in out.items() if k != "checks"}
    line["numbers"] = run.numbers
    line["checks"] = out["checks"]
    print(json.dumps(plain(line)), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
