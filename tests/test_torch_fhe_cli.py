"""The port's TT_FHE family through its CLI, against the JAX CLI on the
CPU: ``--mode compile`` (``summary.json`` byte for byte, ``--verilog``),
``--mode export`` and ``--ckpt`` (keys and values), the refusals (texts
equal to JAX's), ``--bf16`` (JAX's ``cast_floating``), and ``--mode eval``
and ``--mode serve`` as conv, tables and circuit, on 32x32 inputs at
nfilter = tfilter = 4 (``TT_FHE_XSMALL_vAlexnet`` at its fixed p = 64).

Tolerances: eval metrics of the LUT and gate runs equal each other and the
conv run's top-1/5 exactly (loss within 1e-4), and JAX's conv run's top-1/5;
served top-5 equal to the direct LUT forward's.
"""

import io
import json
import os
import threading
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, tree_np

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.utils import cast_floating
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.compile import gate_net
from scale_imagenet_tpu_torch.convert import state_dict_from_jax
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.models import get_model

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

ALEX = "TT_FHE_XSMALL_vAlexnet"


def _kw(name):
    return {} if name == ALEX else dict(nfilter=4, tfilter=4)


def _width(name):
    return ["--model", name] + ([] if name == ALEX else
                                ["--nfilter", "4", "--tfilter", "4"])


def _ckpt(name, tmp_path, seed=4):
    """The port model of ``name`` (weights from ``seed``, BN statistics
    moved) written as a reference-layout ``.pth``."""
    model = get_model(name, **_kw(name)).init(seed=seed, device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.add_(0.2 * torch.randn(
                    m.running_mean.shape,
                    generator=torch.Generator().manual_seed(seed)))
    path = str(tmp_path / f"{name}.pth")
    torch.save({"model_state_dict": model.state_dict()}, path)
    return path, model


@pytest.mark.parametrize("name", ["TT_FHE_SMALL", "TT_FHE_XSMALL", ALEX])
def test_cli_compile_summary_matches_jax(name, tmp_path):
    """``--mode compile --ckpt X.pth``: ``summary.json`` byte-identical to
    the JAX CLI's from the same file, and ``--verilog``'s total equal to
    the circuits' gate count (TT_FHE_SMALL)."""
    ckpt, model = _ckpt(name, tmp_path)
    verilog = ["--verilog"] if name == "TT_FHE_SMALL" else []
    outs = {}
    for tag, entry, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jmain.main, [])):
        outs[tag] = str(tmp_path / tag)
        with redirect_stdout(io.StringIO()):
            entry(["--mode", "compile", "--ckpt", ckpt, "--compile_out",
                   outs[tag], "--root_dir", str(tmp_path), *verilog,
                   *_width(name), *extra])
    with open(os.path.join(outs["port"], "summary.json"), "rb") as f:
        ours = f.read()
    with open(os.path.join(outs["jax"], "summary.json"), "rb") as f:
        assert ours == f.read()
    blocks = json.loads(ours)["blocks"]
    fuse = name == "TT_FHE_SMALL"
    assert sorted(blocks) == ["block0_conv1", "block0_conv2",
                              "block0_conv3"] + (["block0_convf"] if fuse
                                                 else [])
    if verilog:
        manifest = json.load(open(os.path.join(outs["port"], "verilog",
                                               "manifest.json")))
        assert manifest["total_gates"] == gate_net.total_gates(
            cli._family(model.cfg).gate_compile(model))


def test_cli_export_matches_jax_and_reloads(tmp_path):
    """``--mode export`` of TT_FHE_SMALL writes what the JAX CLI writes
    from the same ``.pth``; ``--ckpt`` of it loads strict."""
    ckpt, model = _ckpt("TT_FHE_SMALL", tmp_path)
    files = {}
    for tag, entry, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jmain.main, [])):
        files[tag] = str(tmp_path / f"{tag}.pth")
        with redirect_stdout(io.StringIO()):
            entry(["--mode", "export", "--ckpt", ckpt, "--export_out",
                   files[tag], "--root_dir", str(tmp_path),
                   *_width("TT_FHE_SMALL"), *extra])
    ours = torch.load(files["port"], weights_only=True)["model_state_dict"]
    theirs = torch.load(files["jax"], weights_only=True)["model_state_dict"]
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        # JAX writes its 0-d buffers as (1,) (``np.ascontiguousarray``)
        np.testing.assert_array_equal(ours[k].numpy(), v.numpy().reshape(
            ours[k].shape), err_msg=k)
    again = get_model("TT_FHE_SMALL", **_kw("TT_FHE_SMALL")).init(
        device="cpu")
    cli.load_checkpoint(again, files["jax"])
    x = torch.from_numpy(images((2, 32, 32, 3), 3).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(again(x), model(x))


def _jax_refusal(argv, tmp_path) -> str:
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--root_dir", str(tmp_path), "--mesh_data", "1"])
    return str(err.value)


@pytest.mark.parametrize("name,argv", [
    ("TT_FHE_SMALL", ["--mode", "serve", "--fold_bn"]),
    (ALEX, ["--mode", "serve", "--fold_bn"]),
    (ALEX, ["--mode", "export"]),
], ids=["serve_fold_bn", "serve_fold_bn_alexnet", "export_alexnet"])
def test_refusals_are_the_jax_messages(name, argv, tmp_path):
    """``--fold_bn`` knows the ttnet_imagenet and resnet pairings only, and
    export the ttnet_imagenet family and ``TTFHEConfig`` only."""
    argv = argv + _width(name) + ["--export_out", str(tmp_path / "e.pth")]
    want = _jax_refusal(argv, tmp_path)
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu"])
    assert str(err.value) == want
    assert "TTFHE" in want


def test_train_and_imagefolder_name_the_roadmap(tmp_path):
    """FHE training and the 32^2 ImageFolder route run now
    (``tests/test_torch_fhe_train.py``); on them, robust training refuses
    the plain step's options with the JAX CLI's text, and the native
    decoder, ported since, refuses a 32^2 model with the JAX CLI's text
    (``scale_imagenet_tpu/main.py:1076-1081``)."""
    with pytest.raises(ValueError, match="--grad_accum is not supported "
                                         "with robust training"):
        cli.main(["--mode", "train", "--device", "cpu", "--shards_dir",
                  str(tmp_path), "--stability_eps", "0.1", "--grad_accum",
                  "2", *_width("TT_FHE_SMALL")])
    with pytest.raises(ValueError, match="--native_data is the 256->224 "
                                         "ImageNet decode pipeline; this "
                                         "model's resolution needs the PIL "
                                         "path"), \
            redirect_stdout(io.StringIO()):
        cli.main(["--mode", "eval", "--device", "cpu", "--data_dir",
                  str(tmp_path), "--native_data", *_width("TT_FHE_SMALL")])


def test_bf16_casts_as_jax_cast_floating():
    """``--bf16`` casts every floating parameter and buffer, as JAX's
    ``cast_floating`` casts the trees, and the forward runs in bf16."""
    jm, params, state, md, model = jax_and_port(
        "TT_FHE_SMALL_bireal", np.float32, seed=6, jit=True, nfilter=4,
        tfilter=4)
    cfg = cli.parse_args(["--mode", "serve", "--bf16",
                          *_width("TT_FHE_SMALL_bireal")])
    cli.apply_serving_transforms(cfg, model)
    want = state_dict_from_jax(tree_np(cast_floating(params), np.float32),
                               tree_np(cast_floating(state), np.float32),
                               md.config)
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(v.float().numpy(),
                                          want[k].float().numpy(), err_msg=k)
    x = torch.from_numpy(images((2, 32, 32, 3), 4).astype(np.float32))
    with torch.no_grad():
        y = model(x)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


def test_cli_eval_conv_lut_and_gates(tmp_path):
    """``--mode eval`` from 32^2 shards, ImageNet-normalized as the JAX
    shard route does: conv, ``--lut --lut_path`` (writing, then loading)
    and ``--gates dnf|cnf`` give equal metrics, and the conv's top-1/5;
    no fused launch on the CPU."""
    ckpt, _ = _ckpt("TT_FHE_SMALL", tmp_path, seed=7)
    rng = np.random.default_rng(22)
    u8 = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    write_shards(ArrayDataset(u8, rng.integers(0, 10, 5).astype(np.int32)),
                 str(tmp_path / "shards"))
    base = ["--mode", "eval", "--device", "cpu", "--shards_dir",
            str(tmp_path / "shards"), "--eval_batch_size", "2", "--ckpt",
            ckpt, "--root_dir", str(tmp_path), *_width("TT_FHE_SMALL")]
    lut = ["--lut", "--lut_path", str(tmp_path / "luts.npz")]
    FB.reset_launches()
    with redirect_stdout(io.StringIO()) as out:
        runs = {"conv": cli.main(base), "lut_write": cli.main(base + lut),
                "lut_load": cli.main(base + lut),
                **{form: cli.main(base + ["--gates", form])
                   for form in ("dnf", "cnf")}}
    assert "saved LUTs" in out.getvalue() and "loading LUTs" in \
        out.getvalue() and "runs ON DEVICE" in out.getvalue()
    for name in ("lut_load", "dnf", "cnf"):
        assert runs[name] == runs["lut_write"], name
    assert runs["conv"][:2] == runs["lut_write"][:2]
    assert abs(runs["conv"][2] - runs["lut_write"][2]) < 1e-4
    assert FB.fused_pointwise_block.launches == 0
    # the JAX CLI scores the same shards from the same weights alike
    with redirect_stdout(io.StringIO()):
        jrun = jmain.main([a for a in base if a not in ("--device", "cpu")]
                          + ["--mesh_data", "1"])
    np.testing.assert_allclose(jrun[:2], runs["conv"][:2])


def test_cli_serve_gates(tmp_path):
    """``--mode serve --gates dnf`` on TT_FHE_XSMALL: each answer's top-5
    equals the direct LUT forward's."""
    ckpt, model = _ckpt("TT_FHE_XSMALL", tmp_path, seed=8)
    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            with redirect_stdout(io.StringIO()):
                cli.main(["--mode", "serve", "--device", "cpu", "--port",
                          "0", "--serve_batch", "2", "--gates", "dnf",
                          "--ckpt", ckpt, *_width("TT_FHE_XSMALL")],
                         serve_ready=ready, serve_stop=stop)
        except Exception as e:                  # surfaced below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    xs = images((3, 32, 32, 3), 15).astype(np.float32)
    try:
        assert ready.wait(120) and not errors, errors
        answers = []
        for x in xs:
            req = urllib.request.Request(
                f"http://127.0.0.1:{ready.port}/predict", data=x.tobytes(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read())["top5"])
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive() and not errors
    fam = cli._family(model.cfg)
    logits = fam.lut(fam.lut_compile(model), model, torch.from_numpy(xs))
    assert answers == torch.topk(torch.softmax(logits, -1), 5).indices \
        .tolist()
