"""The port's entry point: ``--mode serve [--lut]`` on the CPU, the card by
default, and the flags of later slices refused by name."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_port import images

from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut, \
    lut_ttnet_apply
from scale_imagenet_tpu_torch.data import imagenet_eval_transform
from scale_imagenet_tpu_torch.device import resolve_device
from scale_imagenet_tpu_torch.models import get_model

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

SMALL = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter",
         "4", "--layers", "0"]


def _post(url, body, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(seed: int) -> bytes:
    """A seeded 300x260 RGB PNG: the eval transform resizes and crops it."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (260, 300, 3), dtype=np.uint8)) \
        .save(buf, format="PNG")
    return buf.getvalue()


def test_batcher_queue_wait_counts_the_forward_ahead():
    """Two back-to-back bursts of four through a batcher of four whose
    forward sleeps: the requests behind the first forward wait in the
    queue at least that forward's sleep, which ``stats()`` reports."""
    from scale_imagenet_tpu_torch.runtime import DynamicBatcher

    gate, entered = threading.Event(), []

    def forward(xs):
        entered.append(len(xs))
        gate.wait(10)
        time.sleep(0.2)
        return xs

    b = DynamicBatcher(forward, np.zeros(3, np.float32), batch_size=4,
                       max_wait_ms=1.0)
    try:
        with ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(b.submit, np.full(3, i, np.float32), 30)
                       for i in range(8)]
            # the first forward is running (held at the gate) and every
            # other request is queued behind it
            deadline = time.monotonic() + 10
            while (not entered or b._q.qsize() < 8 - entered[0]) and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            gate.set()
            got = [f.result(30) for f in futures]
        stats = b.stats()
    finally:
        b.close()
    assert [float(g[0]) for g in got] == list(range(8))
    assert stats["served"] == 8
    # at most four rode the first forward; the rest waited out its sleep
    assert stats["queue_ms_p50"] >= 200.0
    assert stats["queue_ms_p95"] >= stats["queue_ms_p50"]
    assert stats["batch_ms_p50"] >= 200.0


@pytest.mark.parametrize("lut", [True, False])
def test_server_answers_concurrent_requests(lut):
    ready, stop = threading.Event(), threading.Event()
    argv = ["--mode", "serve", "--device", "cpu", "--port", "0",
            "--serve_batch", "4", "--seed", "3", *SMALL]
    if lut:
        argv.append("--lut")
    errors = []

    def run():
        try:
            cli.main(argv, serve_ready=ready, serve_stop=stop)
        except Exception as e:                  # surfaced below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        assert ready.wait(120) and not errors, errors
        url = f"http://127.0.0.1:{ready.port}"
        xs = images((6, 224, 224, 3), 11).astype(np.float32)
        with ThreadPoolExecutor(6) as pool:
            answers = list(pool.map(
                lambda x: _post(url + "/predict", x.tobytes()), xs))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        bad_shape = _post(url + "/predict", xs[0, :10].tobytes())
        png = _png(12)
        image = _post(url + "/predict", png, "image/png")
        bad_image = _post(url + "/predict", png[:40], "image/png")
        unknown = _post(url + "/nope", b"")
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive()
    md = get_model("ttnet_imagenet_xsmall", nfilter=4, tfilter=4, layers=0)
    model = md.init(seed=3, device="cpu")
    if lut:
        luts = compile_ttnet_lut(model)

        def forward(x):
            return lut_ttnet_apply(luts, model, x)
    else:
        forward = model
    from PIL import Image

    decoded = imagenet_eval_transform(Image.open(io.BytesIO(png)))
    with torch.no_grad():
        logits = forward(torch.from_numpy(np.concatenate([xs, decoded[None]])))
    direct = torch.topk(torch.softmax(logits, -1), 5).indices.tolist()
    assert [a[0] for a in answers] == [200] * 6
    assert [a[1]["top5"] for a in answers] == direct[:6]
    assert health["served"] == 6 and health["batch_size"] == 4
    assert 0 <= health["queue_ms_p50"] <= health["queue_ms_p95"]
    assert health["model"].endswith("+lut") == lut
    assert health["device"] == "cpu"
    assert bad_shape[0] == 400 and "shape" in bad_shape[1]["error"]
    # an image upload goes through the PIL eval transform
    assert image[0] == 200 and image[1]["top5"] == direct[6]
    assert bad_image[0] == 400 and "error" in bad_image[1]
    assert unknown[0] == 404


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--mode", "serve", "--lut", *SMALL])
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("ttnet_imagenet_small").init()
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("argv,match", [
    # --native_data, --mesh_model, --tp and --sp are ported
    # (tests/test_torch_native_data.py, tests/test_torch_tp*.py,
    # tests/test_torch_sp*.py): --sp refuses the compiled serving modes
    # beside a model axis, and export refuses --tp, with the JAX CLI's
    # texts
    (["--mode", "eval", "--mesh_model", "2", "--sp", "--lut"],
     "the compiled serving modes .--lut/--gates. walk tables per window"),
    (["--mode", "export", "--tp"],
     "UNMODIFIED weights in the reference layout; --tp does not apply"),
    # ported: serving refuses certified eval with the JAX CLI's text
    (["--mode", "serve", "--certify", "0.1"],
     "single-host inference serving; --certify does not apply"),
    # the server is one process on one card: --sp meets the JAX CLI's
    # checks on a one-device mesh
    (["--mode", "serve", "--sp"], "run with --mesh_model>1")])
def test_unported_modes_and_flags_name_the_roadmap(argv, match):
    with pytest.raises(ValueError, match=match):
        cli.main(argv)


def test_ckpt_loads_a_jax_export_strict(tmp_path):
    """A ``.pth`` written by the JAX package's exporter loads strict and
    serves the same function as ``state_dict_from_jax``."""
    import jax

    from scale_imagenet_tpu.convert.torch_export import save_torch_checkpoint
    from scale_imagenet_tpu.models import get_model as jget
    from scale_imagenet_tpu_torch.convert import state_dict_from_jax

    jm = jget("ttnet_imagenet_xsmall", nfilter=2, tfilter=2, layers=0)
    params, state = jm.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "w.pth")
    save_torch_checkpoint(path, params, state, jm.config)
    md = get_model("ttnet_imagenet_xsmall", nfilter=2, tfilter=2, layers=0)
    model = md.init(seed=0, device="cpu")
    cli.load_checkpoint(model, path)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), md.config)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="ROADMAP"):
        cli.load_checkpoint(model, str(tmp_path / "orbax_dir"))
