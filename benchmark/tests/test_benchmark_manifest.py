"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""

from __future__ import annotations

import ast
import json

import pytest

from harness import manifest

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.manifest()


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 10 <= bench["run_seconds"] <= 51
    text = json.dumps(bench)
    assert len(text.encode()) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    for name in names:
        assert manifest.NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert manifest.NAME.match("eval_img_s")
    assert not manifest.NAME.match("eval img/s")
    assert manifest.UNIT.match("images/s") and manifest.UNIT.match("%")
    assert not manifest.UNIT.match("images per second")
    assert not manifest.UNIT.match("μs")


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", [
    "small.eval.conv", "v1.eval.conv", "small.train.f32"])
def test_cell_files_resolve(bench, workload):
    cell = manifest.cell(workload, bench)
    assert cell.chips == 1
    assert manifest.reference(cell.config["reference"]).build
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {e["name"] for e in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for entry, mod in cell.per_layer:
        assert mod.UNIT == entry["unit"]
        assert mod.MOVES == entry["moves"] and mod.MOVES in reported
        assert mod.LAYER == entry["layer"]


def test_configs_and_cells(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        data = manifest.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert data["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200


def test_kept_table_cell_files_resolve():
    """The table cell's files, kept for its return (PERF.md)."""
    from conftest import cell

    c = cell("small.eval.lut")
    assert c.traffic["path"] == "lut" and c.limits
    assert manifest.reader("lut_window_roofline").UNIT == "%"


def test_per_layer_layers_agree(bench):
    layers: dict = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_references_import_nothing_of_the_program():
    for path in (manifest.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            for top in tops:
                assert top in ("torch", "math", "__future__"), (path, top)
