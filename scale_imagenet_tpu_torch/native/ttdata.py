"""ctypes binding of the native image loader ``native/ttdata.cpp`` (the
port's own counterpart of ``scale_imagenet_tpu/native/ttdata.py``), the
``--native_data`` decode route of ``--mode eval``.

The repo-root source is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17 ... -ljpeg`` into ``build/native/`` at the repo root, under a
name that carries a hash of the source and the flags, and moved into place
atomically, as ``native/ttlogic.py`` and ``kernels/build.py`` do: ranks that
build at once never load a torn library.  Nothing builds at import time.

There is no fallback.  A failed build raises at the first use with the
compiler's error (the JAX binding swallows it and fails at the first
image); the caller asks for the library before it reads any image
(``require``).  The loader decodes with libjpeg, resizes the shorter side
to 256 with PIL's own fixed-point antialiased bilinear filter, takes the
224 centre crop and normalizes with the ImageNet statistics: the images
equal those of the PIL route (``data/transforms.py::
imagenet_eval_transform``) bit for bit, HWC float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..data.dataset import ImageFolder
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "ttdata.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib = None

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(
        CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libttdata-{digest[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (--native_data "
                           f"needs g++, jpeglib.h and libjpeg):\n{r.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build never tears it


def _library() -> ctypes.CDLL:
    """Build (if needed) and load the loader, its argument types declared
    as ``scale_imagenet_tpu/native/ttdata.py:41-48`` declares them."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.ttdata_load_eval_batch.restype = ctypes.c_int
        lib.ttdata_load_eval_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, _f32p, ctypes.c_int,
            ctypes.c_int, _f32p, _f32p, _u8p]
        _lib = lib
        return lib


def require() -> None:
    """Build and load the library now: a missing compiler or libjpeg
    raises before any image is read."""
    _library()


def load_eval_batch(paths: list[str], crop: int = 224,
                    resize_to: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Decode, resize, crop and normalize a batch of JPEGs.  Returns
    ``(images (n, crop, crop, 3) float32, fail (n,) uint8)``: an image that
    does not decode (or is smaller than the crop after the resize) is left
    zero with its ``fail`` flag set."""
    lib = _library()
    n = len(paths)
    out = np.zeros((n, crop, crop, 3), np.float32)
    fail = np.zeros(n, np.uint8)
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    mean = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
    std = np.ascontiguousarray(IMAGENET_STD, np.float32)
    lib.ttdata_load_eval_batch(
        blob, n, out.ctypes.data_as(_f32p), crop, resize_to,
        mean.ctypes.data_as(_f32p), std.ctypes.data_as(_f32p),
        fail.ctypes.data_as(_u8p))
    return out, fail


class NativeImageFolder:
    """``ImageFolder`` with the native decode (the eval transform built
    in): the same ``(image, label)`` items, classes and samples.  The
    library is built when the folder is made."""

    def __init__(self, root: str, crop: int = 224, resize_to: int = 256):
        require()
        base = ImageFolder(root, transform=None)
        self.root = root
        self.samples = base.samples
        self.classes = base.classes
        self.class_to_idx = base.class_to_idx
        self.crop, self.resize_to = crop, resize_to

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        imgs, fail = load_eval_batch([path], self.crop, self.resize_to)
        if fail[0]:
            raise IOError(f"native decode failed: {path}")
        return imgs[0], label
