"""The run's refusals: the no-JAX guard by whole top-level module name, a
run with no card, and a run in a directory that holds only the
benchmark's files."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

import run as bench


@pytest.mark.parametrize("names, found", [
    (["scale_imagenet_tpu_torch", "scale_imagenet_tpu_torch.models",
      "torch", "jaxtyping", "flaxen"], []),
    (["scale_imagenet_tpu"], ["scale_imagenet_tpu"]),
    (["scale_imagenet_tpu.models.registry", "scale_imagenet_tpu_torch"],
     ["scale_imagenet_tpu"]),
    (["jax"], ["jax"]), (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "jax.numpy"], ["flax", "jax"]),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert bench.forbidden_modules(dict.fromkeys(names)) == found


def _no_json(stdout: str) -> bool:
    return not any(line.lstrip().startswith("{")
                   for line in stdout.splitlines())


def test_run_without_a_card_fails():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "small.eval.conv",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=bench.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert _no_json(p.stdout)
    assert "CUDA" in p.stderr


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    """Past the look for a card, the program cannot be imported."""
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "run.require_cards = lambda n: None; "
            "sys.exit(run.main(['--workload', 'small.eval.conv', '--seed', "
            "'3', '--seconds', '1', '--trace', '0']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0
    assert _no_json(p.stdout)
    assert "scale_imagenet_tpu_torch" in p.stderr
