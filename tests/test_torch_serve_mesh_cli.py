"""``python -m scale_imagenet_tpu_torch.main --mode serve`` over several
devices in one process, on the CPU: ``--device cpu --cpu_devices N`` (or
``main(devices=...)``) gives the mesh N CPU devices, as the JAX CLI's
``--cpu_devices`` (its tests' 8 virtual CPU devices) does.

* JAX's ``tests/test_serve.py::test_cli_serve_mesh_sharded`` (2x4
  ``--sp``) and ``::test_cli_serve_lut_mesh_dp`` (``--lut --mesh_data 2``)
  mirrored: concurrent requests to the server in a thread, each served
  top-1 equal to the JAX forward's argmax on the same weights (the port's
  ``--seed`` init carried to JAX's trees by ``convert.jax_trees``), and
  ``/healthz`` reporting the mesh and its devices;
* ``TT_FHE_small`` at 2x1: two servers from one ``--seed`` (one through
  ``--cpu_devices``, one through ``devices=``) answer the same requests,
  one a batch, alike;
* the JAX serve branch's refusals with its texts (``scale_imagenet_tpu/
  main.py:900-929``), over the same 8 devices: ``--sp`` with ``--lut`` and
  ``--gates``, ``--serve_batch`` not divisible by the data axis, a model
  axis of 1, an indivisible height, a mesh larger than the devices and a
  device count the model axis does not divide; and the port's own rules
  for ``--cpu_devices``.
"""

import io
import json
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu import train as jtrain
from scale_imagenet_tpu.models import get_model as jget
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.models import get_model

pytestmark = pytest.mark.usefixtures("few_threads")

WIDTH = ["--nfilter", "4", "--tfilter", "4"]
FLAGSHIP = [*WIDTH, "--layers", "0"]


def _post(url: str, x: np.ndarray) -> dict:
    req = urllib.request.Request(
        url + "/predict", data=np.ascontiguousarray(x, np.float32).tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve(argv: list, xs: np.ndarray, devices=None,
           one_at_a_time: bool = False):
    """``main --mode serve`` in a thread on the CPU, one request an image
    of ``xs`` (all at once, or each after the last's answer): the answers
    and ``/healthz``."""
    ready, stop, errors = threading.Event(), threading.Event(), []

    def run():
        try:
            with mock.patch.dict(sys.modules,
                                 {"torch.utils.tensorboard": None}):
                cli.main(["--mode", "serve", "--device", "cpu", "--port",
                          "0", *argv], serve_ready=ready, serve_stop=stop,
                         devices=devices)
        except BaseException as e:          # noqa: BLE001: reported below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        assert ready.wait(240) and not errors, errors
        url = f"http://127.0.0.1:{ready.port}"
        if one_at_a_time:
            answers = [_post(url, x) for x in xs]
        else:
            with ThreadPoolExecutor(len(xs)) as pool:
                answers = list(pool.map(lambda x: _post(url, x), xs))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and not errors, errors
    return answers, health


def _jax_argmax(name: str, xs: np.ndarray, **kw) -> np.ndarray:
    """The JAX forward's argmax on the port's ``--seed 0`` weights."""
    model = get_model(name, **kw).init(seed=0, device="cpu")
    params, state = jax_trees(model)
    jm = jget(name, **kw)
    logits, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, training=False))(
        params, state, xs)
    return np.asarray(logits).argmax(1)


def test_cli_serve_mesh_sharded(tmp_path):
    """2x4 ``--sp`` over 8 CPU devices: each of six concurrent answers'
    top-1 is the JAX forward's argmax."""
    xs = np.random.default_rng(7).standard_normal(
        (6, 224, 224, 3)).astype(np.float32)
    answers, health = _serve(
        [*FLAGSHIP, "--cpu_devices", "8", "--serve_batch", "4",
         "--serve_wait_ms", "20", "--mesh_data", "2", "--mesh_model", "4",
         "--sp", "--root_dir", str(tmp_path)], xs)
    want = _jax_argmax("ttnet_imagenet_small", xs, nfilter=4, tfilter=4,
                       layers=0)
    assert [a["top5"][0] for a in answers] == want.tolist()
    assert health["mesh"] == {"data": 2, "model": 4} and health["spatial"]
    assert health["devices"] == ["cpu"] * 8 and health["served"] == 6


def test_cli_serve_lut_mesh_dp(tmp_path):
    """``--lut --mesh_data 2`` (an explicit data axis: the compiled modes
    take one device by default) over 2 CPU devices, TT_FHE_SMALL at 32²,
    its tables written to ``--lut_path``: each top-1 the JAX forward's
    argmax."""
    xs = np.random.default_rng(13).standard_normal(
        (6, 32, 32, 3)).astype(np.float32)
    lut_path = tmp_path / "luts.npz"
    answers, health = _serve(
        ["--model", "TT_FHE_SMALL", *WIDTH, "--lut", "--lut_path",
         str(lut_path), "--cpu_devices", "2", "--mesh_data", "2",
         "--serve_batch", "4", "--serve_wait_ms", "20", "--root_dir",
         str(tmp_path)], xs)
    want = _jax_argmax("TT_FHE_SMALL", xs, nfilter=4, tfilter=4)
    assert [a["top5"][0] for a in answers] == want.tolist()
    assert health["mesh"] == {"data": 2, "model": 1}
    assert health["model"].endswith("+lut") and lut_path.exists()
    # without --mesh_data the tables take one device, as in JAX
    _, one = _serve(["--model", "TT_FHE_SMALL", *WIDTH, "--lut",
                     "--lut_path", str(lut_path), "--cpu_devices", "2",
                     "--root_dir", str(tmp_path)], xs[:1])
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["devices"] == ["cpu"]


def test_stochastic_servers_repeat_from_one_seed(tmp_path):
    """``TT_FHE_small`` at 2x1: one request a batch (data index 0 holds it,
    data index 1 the padding), the flips of each batch keyed from
    ``--seed``: the two servers' answers equal, request for request."""
    xs = np.random.default_rng(3).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    argv = ["--model", "TT_FHE_small", "--nfilter", "1", "--tfilter", "8",
            "--seed", "6", "--mesh_data", "2", "--serve_batch", "2",
            "--serve_wait_ms", "1", "--root_dir", str(tmp_path)]
    first, health = _serve([*argv, "--cpu_devices", "2"], xs,
                           one_at_a_time=True)
    again, health2 = _serve(argv, xs, devices=[torch.device("cpu")] * 2,
                            one_at_a_time=True)
    assert health["mesh"] == health2["mesh"] == {"data": 2, "model": 1}
    assert health["batches"] == health2["batches"] == 4
    assert [(a["top5"], a["probs"]) for a in first] \
        == [(a["top5"], a["probs"]) for a in again]


# ------------------------------------------------------------ refusals

class _NoLogger:
    def __init__(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _zero_params(cfg, model):
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        jax.eval_shape(model.init, jax.random.PRNGKey(0)))


def _jax_error(argv):
    with mock.patch.object(jmain, "load_params", _zero_params), \
            mock.patch.object(jtrain, "MetricsLogger", _NoLogger), \
            pytest.raises(Exception) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv)
    return err.value


REFUSED = {
    "sp_lut": ["--mesh_data", "2", "--mesh_model", "4", "--sp", "--lut"],
    "sp_gates": ["--mesh_data", "2", "--mesh_model", "4", "--sp", "--gates",
                 "dnf"],
    "serve_batch": ["--mesh_data", "2", "--serve_batch", "3"],
    "serve_batch_sp": ["--mesh_data", "2", "--mesh_model", "4", "--sp",
                       "--serve_batch", "5"],
    "model_axis": ["--mesh_data", "2", "--sp"],
    "height": ["--mesh_data", "2", "--mesh_model", "3", "--sp"],
    "too_large": ["--mesh_data", "4", "--mesh_model", "4"],
    "too_large_lut": ["--mesh_data", "9", "--lut"],
    "indivisible": ["--mesh_model", "3"],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_serve_refusals_are_the_jax_texts(tmp_path, name):
    """Over 8 devices on both sides (JAX's virtual CPU devices, the port's
    ``--cpu_devices 8``): the same exception text."""
    argv = ["--mode", "serve", *FLAGSHIP, "--root_dir", str(tmp_path),
            *REFUSED[name]]
    want = _jax_error(argv)
    assert isinstance(want, ValueError), want
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu", "--cpu_devices", "8"])
    assert str(got.value) == str(want)


@pytest.mark.parametrize("argv,match", [
    (["--mode", "serve", "--cpu_devices", "2"], "--platform/--cpu_devices "
                                                "pick the JAX package's"),
    (["--mode", "eval", "--shards_dir", "d", "--device", "cpu",
      "--cpu_devices", "2"], "--platform/--cpu_devices pick"),
    (["--mode", "serve", "--device", "cpu", "--cpu_devices", "0"],
     "--cpu_devices 0: a count >= 1 of CPU devices"),
    (["--mode", "serve", "--device", "cpu", "--platform", "cpu"],
     "--platform/--cpu_devices pick")],
    ids=["serve_on_the_card", "eval", "zero", "platform"])
def test_cpu_devices_rules(argv, match):
    """``--cpu_devices`` gives ``--mode serve --device cpu`` its devices and
    is refused elsewhere; ``--platform`` always."""
    with pytest.raises(ValueError, match=match):
        cli.main(argv + FLAGSHIP)
