"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface, so ``nvcc`` builds it in
seconds (no PyTorch headers) into ``build/kernels/`` at the repo root, a
directory ``.gitignore`` lists.  The file name carries a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads.
The library is loaded with ``ctypes``.  Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp, out)`` or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent build never tears it


def build_all() -> dict[str, Path]:
    """Build every source under ``csrc/``, one ``nvcc`` each, all started
    together.  Returns ``{name: library path}``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        jobs = [j for j in (_start_build(n) for n in names) if j is not None]
        for job in jobs:
            _finish_build(job)
    return {n: library_path(n) for n in names}


_checked: dict[int, tuple] = {}


def check_device(device) -> None:
    """Raise unless ``device`` (a card) is sm_90, the one architecture the
    libraries hold code for; each card is asked once.  Every wrapper calls
    it before it launches on a card, so a process that spans several cards
    checks each before its first launch there."""
    import torch

    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    cap = _checked.get(index)
    if cap is None:
        cap = _checked[index] = tuple(torch.cuda.get_device_capability(index))
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"cuda:{index} is sm_{cap[0]}{cap[1]}")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; needs an sm_90 card
    (``check_device``)."""
    import torch

    with _lock:
        if name in _loaded:
            return _loaded[name]
        check_device(torch.device("cuda"))
        job = _start_build(name)
        if job is not None:
            _finish_build(job)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
