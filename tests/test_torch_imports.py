"""The port stands alone: no file of it, nor ``chip_smoke.py``, imports JAX
or anything of the JAX package, and every module imports without a card,
``nvcc``, ``triton``, Pillow or sympy (the card's machine has none of the
last three: the shard path needs numpy only, and the gate compiler uses
the native engine, which the port builds itself)."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "scale_imagenet_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "scale_imagenet_tpu")


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(n for n in _imported(path) if _forbidden(n))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\n"
                 "from scale_imagenet_tpu.models import get_model\n"
                 "from scale_imagenet_tpu_torch import main\n")
    assert sorted(n for n in _imported(f) if _forbidden(n)) == \
        ["jax.numpy", "scale_imagenet_tpu.models"]


def test_every_module_imports_without_jax():
    mods = ["scale_imagenet_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)],
                                              "scale_imagenet_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'scale_imagenet_tpu', 'triton', 'PIL', "
            "'sympy')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) > 20
    # the training slice's modules are among them
    assert {"scale_imagenet_tpu_torch.train.augment",
            "scale_imagenet_tpu_torch.train.optim",
            "scale_imagenet_tpu_torch.runtime.checkpoint"} <= set(mods)
    # and the gate compiler's
    assert {"scale_imagenet_tpu_torch.native.ttlogic",
            "scale_imagenet_tpu_torch.compile.logic",
            "scale_imagenet_tpu_torch.compile.gate_net",
            "scale_imagenet_tpu_torch.compile.gate_device",
            "scale_imagenet_tpu_torch.compile.verilog",
            "scale_imagenet_tpu_torch.kernels.gate_cubes"} <= set(mods)
    # and the serving transforms'
    assert {"scale_imagenet_tpu_torch.convert.bn_fold",
            "scale_imagenet_tpu_torch.convert.export"} <= set(mods)


def test_port_builds_and_loads_its_own_native_engine():
    """The gate compiler loads ``build/native/libttlogic-*.so``, built from
    ``native/ttlogic.cpp``, never the JAX package's ``_ttlogic.so``."""
    code = ("from scale_imagenet_tpu_torch.compile.logic import "
            "minimize_packed\n"
            "from scale_imagenet_tpu_torch.native import pack_table_bits\n"
            "minimize_packed(pack_table_bits([0, 1, 1, 1]), 2)\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert '_ttlogic.so' not in maps\n"
            "assert '/build/native/libttlogic-' in maps\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert not [p for p in FILES if "_ttlogic.so" in p.read_text()]
