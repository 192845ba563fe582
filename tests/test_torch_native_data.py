"""The port's binding of the native image loader (``native/ttdata.cpp``,
``--native_data``) against the JAX package's on the CPU: it builds here
into ``build/native/``; its images equal JAX's ``load_eval_batch`` and
the port's PIL route (``imagenet_eval_transform``) bit for bit on JPEGs of
mixed geometries (those of ``tests/test_native_data.py``); undecodable
files are flagged and left zero; ``NativeImageFolder`` yields the PIL
route's items; a failed build raises with g++'s error; ``main --mode eval
--native_data`` prints the PIL route's metrics; and the flag's refusals
carry the JAX CLI's text (or, where the JAX CLI lets the flag do nothing,
the port's own rule).
"""

import io
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest

from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu import train as jtrain
from scale_imagenet_tpu.native import ttdata as jttdata
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.data import ImageFolder, imagenet_eval_transform
from scale_imagenet_tpu_torch.native import ttdata
from scale_imagenet_tpu_torch.native.ttdata import NativeImageFolder, \
    load_eval_batch

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

SMALL = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter",
         "4", "--layers", "0"]
GEOMETRIES = [(280, 300), (500, 375), (256, 256), (300, 257)]


def _jpeg(path, w, h, i, rng):
    """A smooth gradient or pure noise (the resampler's hard case)."""
    from PIL import Image

    if i % 2:
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        arr = np.stack([(xx * (i + 1)) % 256, (yy * 2) % 256,
                        ((xx + yy) // 2) % 256], -1).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=95)


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """``root/val/<class>/*.jpg``: two classes, the four geometries each
    (and two more sizes in the second)."""
    root = tmp_path_factory.mktemp("native_jpegs")
    rng = np.random.default_rng(0)
    sizes = {"class_a": GEOMETRIES,
             "class_b": GEOMETRIES + [(640, 480), (333, 500)]}
    for c, geoms in sizes.items():
        d = root / "val" / c
        d.mkdir(parents=True)
        for i, (w, h) in enumerate(geoms):
            _jpeg(d / f"g{i}.jpg", w, h, i, rng)
    return root


def test_binding_builds_here_into_build_native():
    ttdata.require()
    lib = ttdata._library()
    assert ttdata.library_path().exists()
    assert lib._name == str(ttdata.library_path())
    assert "/build/native/libttdata-" in lib._name


def test_pixel_exact_vs_jax_and_the_pil_route(jpeg_root):
    pil = ImageFolder(str(jpeg_root / "val"), imagenet_eval_transform)
    paths = [p for p, _ in pil.samples]
    got, fail = load_eval_batch(paths)
    assert got.shape == (len(paths), 224, 224, 3) and got.dtype == np.float32
    assert not fail.any()
    want, jfail = jttdata.load_eval_batch(paths)
    assert not jfail.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.stack([pil[i][0] for i in range(len(pil))]))


def test_failure_mask(tmp_path, jpeg_root):
    bad = tmp_path / "not_a_jpeg.jpg"
    bad.write_bytes(b"garbage")
    good = str(next((jpeg_root / "val" / "class_a").glob("*.jpg")))
    imgs, fail = load_eval_batch([good, str(bad), str(tmp_path / "absent")])
    jimgs, jfail = jttdata.load_eval_batch([good, str(bad)])
    assert fail.tolist() == [0, 1, 1] and jfail.tolist() == [0, 1]
    assert not imgs[1:].any()
    np.testing.assert_array_equal(imgs[:2], jimgs)


def test_native_image_folder_yields_the_pil_route(jpeg_root, tmp_path):
    root = str(jpeg_root / "val")
    nat, pil = NativeImageFolder(root), ImageFolder(root,
                                                    imagenet_eval_transform)
    assert len(nat) == len(pil) == 10
    assert nat.classes == pil.classes == ["class_a", "class_b"]
    assert nat.samples == pil.samples
    for i in (0, 5, 9):
        img, label = nat[i]
        want, wlabel = pil[i]
        np.testing.assert_array_equal(img, want)
        assert label == wlabel
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "broken.jpg").write_bytes(b"\xff\xd8 truncated")
    with pytest.raises(IOError, match="native decode failed"):
        NativeImageFolder(str(tmp_path))[0]


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    broken = tmp_path / "ttdata.cpp"
    broken.write_text("#include <jpeglib.h>\nint f( { return 0; }\n")
    monkeypatch.setattr(ttdata, "SRC", broken)
    monkeypatch.setattr(ttdata, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ttdata, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                                           "ttdata.cpp") as err:
        NativeImageFolder(str(tmp_path))
    assert "error" in str(err.value)
    # nothing half-built is left to load
    assert not list((tmp_path / "build").glob("*"))


def test_main_eval_native_data_equals_the_pil_route(jpeg_root, tmp_path):
    common = ["--mode", "eval", "--device", "cpu", "--data_dir",
              str(jpeg_root), "--eval_batch_size", "4", "--num_workers", "2",
              "--root_dir", str(tmp_path), *SMALL]
    out = io.StringIO()
    with redirect_stdout(out):
        native = cli.main(common + ["--native_data"])
    pil = cli.main(common)
    assert native == pil
    assert "scored 10 images" in out.getvalue()


def _zero_params(cfg, model):
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        jax.eval_shape(model.init, jax.random.PRNGKey(0)))


class _NoLogger:
    def __init__(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _jax_error(argv, root):
    """The JAX CLI's error for ``argv`` (zero weights of the init's
    shapes, no TensorBoard writer: both cost seconds and decide
    nothing here)."""
    with mock.patch.object(jmain, "load_params", _zero_params), \
            mock.patch.object(jtrain, "MetricsLogger", _NoLogger), \
            pytest.raises(Exception) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--mesh_data", "1", "--root_dir", root])
    return err.value


@pytest.mark.parametrize("argv", [
    ["--mode", "serve", "--native_data"],
    ["--mode", "export", "--native_data"],
    ["--mode", "train", "--native_data", "--shards_dir", "d"],
], ids=["serve", "export", "train"])
def test_refusals_carry_the_jax_cli_text(argv, tmp_path):
    want = _jax_error(argv + SMALL, str(tmp_path))
    with pytest.raises(type(want)) as got:
        cli.main(argv + SMALL + ["--device", "cpu"])
    assert str(got.value) == str(want)


def test_a_32px_model_refuses_as_jax(jpeg_root, tmp_path):
    """The 256->224 pipeline only: JAX refuses when it builds the loader
    (``scale_imagenet_tpu/main.py:1076-1081``)."""
    argv = ["--mode", "eval", "--data_dir", str(jpeg_root), "--native_data",
            "--model", "TT_FHE_SMALL", "--nfilter", "4", "--tfilter", "4"]
    want = _jax_error(argv, str(tmp_path))
    with pytest.raises(type(want)) as got, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu", "--root_dir", str(tmp_path)])
    assert str(got.value) == str(want)


@pytest.mark.parametrize("argv,match", [
    (["--mode", "compile", "--native_data"],
     "--mode compile runs in one process on one device; --native_data "
     "does not apply"),
    (["--mode", "eval", "--native_data", "--shards_dir", "d"],
     "--native_data decodes the JPEGs of --data_dir; --shards_dir holds "
     "decoded images — drop one")], ids=["compile", "shards"])
def test_the_port_refuses_where_jax_lets_the_flag_do_nothing(argv, match):
    with pytest.raises(ValueError, match=match):
        cli.parse_args(argv)
