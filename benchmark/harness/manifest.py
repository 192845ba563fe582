"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric, cell's limits or plain reference sits in a file of its own,
found by its name:

    benchmark/configs/<config>.json      sizes, program entry, reference
    benchmark/traffic/<traffic>.json     mode, path, batch, images, feed
    benchmark/metrics/<metric>.py        a reader: read(run) -> float|None
    benchmark/limits/<workload>.json     the comparison's limits
    benchmark/reference/<family>.py      build(model cfg) -> nn.Module

so a later change adds a cell, a mix or a metric as new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list      # the manifest's entries this cell reports
    per_layer: list       # (entry, reader module)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader module."""
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                       "metric_" + metric.replace(".", "_"))


def reference(family: str):
    return load_module(BENCH_DIR / "reference" / f"{family}.py",
                       "reference_" + family)


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of the manifest, with its files read."""
    bench = manifest() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=workload, config=config(w["config"]), traffic=traffic,
        limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        chips=w["chips"],
        end_to_end=[e for e in bench["end_to_end"] if _reports(e, workload)],
        per_layer=[(e, reader(e["name"])) for e in bench["per_layer"]
                   if _reports(e, workload)])
