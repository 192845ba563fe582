"""The port's gate compiler and circuits through its entry points, against
the JAX package: the ``compile_model_truth_tables`` file tree, ``main
--mode compile --verilog``, ``--mode eval --gates`` against ``--lut``,
``--mode serve --gates`` and the refusals, on ``ttnet_imagenet_xsmall``
(nfilter 4, tfilter 4, ``--layers 0``) on the CPU.

Tolerances: artifacts, Verilog text, ``summary.json`` and the eval metrics
are equal.  One exception is stated where it is checked: the last block's
fuse head is float-valued (ReLU), and its artifacts are named by their f32
values, which the two compilers sum in another order.
"""

import io
import json
import os
import re
import threading
import urllib.request
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_from_jax, images, perturb_state, tree_np

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.compile import truth_table as jtt
from scale_imagenet_tpu.convert.torch_export import save_torch_checkpoint
from scale_imagenet_tpu.models import get_model as jget
from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.compile import gate_device, gate_net, \
    logic, truth_table
from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
    IMAGENET_STD, write_shards
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    ttnet_imagenet_apply
from scale_imagenet_tpu_torch.train import make_input_pipeline

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

KW = dict(nfilter=4, tfilter=4, layers=0)
SMALL = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter",
         "4", "--layers", "0"]


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_compile_model_truth_tables_tree_matches_jax(tmp_path):
    """Heaviside blocks through both compilers: the n <= 12 expression
    path, the n > 12 cube path (espresso, packed tables, DIMACS), a block
    with constant filters and one left unminimized; byte-identical trees
    and summaries."""
    items = [
        ("a_n4", dict(in_planes=16, out_planes=8, k=1, padding=0,
                      groupsici=4), 31),
        ("b_n14", dict(in_planes=14, out_planes=2, k=1, padding=0,
                       groupsici=1), 32),
        ("c_n8", dict(in_planes=8, out_planes=4, k=2, padding=1, stride=2,
                      groupsici=2), 33),
    ]
    jitems, pitems = [], []
    for name, kw, seed in items:
        p, s, block = block_from_jax(kw, seed, np.float32)
        jitems.append((name, jax.tree.map(jnp.asarray, p),
                       jax.tree.map(jnp.asarray, s), JBlockCfg(**kw)))
        pitems.append((name, block))
    for bits in (16, 12):
        jsum = jtt.compile_model_truth_tables(
            jitems, str(tmp_path / f"jax{bits}"), max_minimize_bits=bits)
        psum = truth_table.compile_model_truth_tables(
            pitems, str(tmp_path / f"port{bits}"), max_minimize_bits=bits,
            threads=3)
        assert psum == jsum
        want = _tree(str(tmp_path / f"jax{bits}"))
        got = _tree(str(tmp_path / f"port{bits}"))
        assert sorted(got) == sorted(want) and got == want
    names = list(want)
    assert any("dnf_terms" in n for n in _tree(str(tmp_path / "jax16")))
    assert any("DNF_expression" in n for n in names)
    assert any(n.startswith("b_n14/Truth_Table") for n in names)


def test_compile_then_gates_minimize_each_filter_once(tmp_path,
                                                      monkeypatch):
    """Inside ``table_cache()`` (``--mode compile --verilog``) the gate
    compiler reuses the n > 12 covers the artifacts were written from:
    espresso runs twice a filter (DNF and complement), not four times, and
    the covers equal a compile outside the cache."""
    kw = dict(in_planes=14, out_planes=2, k=1, padding=0, groupsici=1)
    block = block_from_jax(kw, 32, np.float32)[2]
    calls = []
    espresso = logic.espresso_cover
    monkeypatch.setattr(logic, "espresso_cover",
                        lambda *a: calls.append(1) or espresso(*a))
    with truth_table.table_cache():
        truth_table.compile_model_truth_tables(
            [("b_n14", block)], str(tmp_path), max_minimize_bits=16)
        assert len(calls) == 4
        cached = gate_net.compile_block_gates(block)
        assert len(calls) == 4
    fresh = gate_net.compile_block_gates(block)
    assert len(calls) == 8
    assert cached.gates == fresh.gates and cached.constants == \
        fresh.constants
    for a, b in zip(cached.covers + cached.cnf_covers,
                    fresh.covers + fresh.cnf_covers):
        np.testing.assert_array_equal(a, b)


def _value_free(name: str) -> str:
    return re.sub(r"\d+\.\d+(e-\d+)?", "V", name)


def test_main_compile_verilog_writes_the_jax_summary(tmp_path):
    """``--mode compile --verilog --ckpt X.pth`` through both CLIs from one
    exported checkpoint: ``summary.json`` byte-identical, every artifact
    of the boolean blocks and the Verilog byte-identical.  The last
    block's float (ReLU) fuse head is named by its f32 values, which the
    two compilers round differently in the last bit: its files are
    compared with the values masked."""
    jm = jget("ttnet_imagenet_xsmall", **KW)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    state = perturb_state(tree_np(state), 7)
    ckpt = str(tmp_path / "w.pth")
    save_torch_checkpoint(ckpt, params, state, jm.config)
    argv = ["--mode", "compile", *SMALL, "--verilog", "--ckpt", ckpt]
    with redirect_stdout(io.StringIO()):
        jsum = jmain.main(argv + ["--compile_out", str(tmp_path / "jax"),
                                  "--root_dir", str(tmp_path)])
    out = io.StringIO()
    with redirect_stdout(out):
        psum = cli.main(argv + ["--compile_out", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert psum == jsum and psum["weights"] == "w.pth"
    assert f"total gates: {psum['total_gates']:,}" in out.getvalue()
    want, got = _tree(str(tmp_path / "jax")), _tree(str(tmp_path / "port"))
    assert got["summary.json"] == want["summary.json"]
    last = "block1_convf/"
    same = {k for k in want if not k.startswith(last)}
    assert {k for k in got if not k.startswith(last)} == same
    assert all(got[k] == want[k] for k in same)
    assert any(k.startswith("verilog/") for k in same)
    assert sorted(map(_value_free, (k for k in got if k.startswith(last)))) \
        == sorted(map(_value_free, (k for k in want if k.startswith(last))))


def _labelled_shards(tmp_path, n=10, seed=3):
    """Seeded uint8 images labelled by the small model's own argmax."""
    imgs = (images((n, 224, 224, 3), 9) * 255).astype(np.uint8)
    model = get_model("ttnet_imagenet_xsmall", **KW).init(seed=seed,
                                                          device="cpu")
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    with torch.no_grad():
        labels = ttnet_imagenet_apply(model, prepare(torch.from_numpy(
            imgs))).argmax(1).numpy().astype(np.int32)
    labels[0] = (labels[0] + 1) % 1000                      # one miss
    root = str(tmp_path / "shards")
    write_shards(ArrayDataset(imgs, labels), root, shard_size=4)
    return root


def test_main_eval_gates_equals_lut(tmp_path, monkeypatch):
    """``--mode eval --gates dnf|cnf`` reports exactly the ``--lut`` run's
    top-1, top-5 and loss: the same bits and the same float parts.  The
    device circuit (the kernel's plain version here) and the host circuit
    (``gates_device_budget = 0``) alike, each announced as JAX does."""
    root = _labelled_shards(tmp_path)
    base = ["--mode", "eval", "--device", "cpu", "--shards_dir", root,
            "--eval_batch_size", "4", "--seed", "3", "--root_dir",
            str(tmp_path), *SMALL]
    with redirect_stdout(io.StringIO()):
        lut = cli.main(base + ["--lut"])
    assert lut[0] == pytest.approx(100 * 9 / 10)
    for form in ("dnf", "cnf"):
        for budget, where in ((1 << 30, "runs ON DEVICE"),
                              (0, "runs on HOST")):
            monkeypatch.setattr(config.performance, "gates_device_budget",
                                budget)
            out = io.StringIO()
            with redirect_stdout(out):
                got = cli.main(base + ["--gates", form])
            assert got == lut
            assert f"gate circuit {where}" in out.getvalue()
            assert f"({form} form)" in out.getvalue()


def test_main_serve_gates_answers_as_the_direct_forward(monkeypatch):
    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            with redirect_stdout(io.StringIO()):
                cli.main(["--mode", "serve", "--gates", "dnf", "--device",
                          "cpu", "--port", "0", "--serve_batch", "4",
                          "--seed", "3", *SMALL],
                         serve_ready=ready, serve_stop=stop)
        except Exception as e:                  # surfaced below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        assert ready.wait(120) and not errors, errors
        url = f"http://127.0.0.1:{ready.port}"
        xs = images((5, 224, 224, 3), 13).astype(np.float32)
        answers = []
        for x in xs:
            req = urllib.request.Request(
                url + "/predict", data=x.tobytes(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read()))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive() and not errors
    assert health["model"].endswith("+gates")
    model = get_model("ttnet_imagenet_xsmall", **KW).init(seed=3,
                                                          device="cpu")
    gdevs = gate_device.build_device_gates(
        gate_net.compile_ttnet_gates(model), "dnf")
    logits = gate_device.gate_ttnet_apply_device(gdevs, model,
                                                 torch.from_numpy(xs))
    direct = torch.topk(torch.softmax(logits, -1), 5).indices.tolist()
    assert [a["top5"] for a in answers] == direct
    # a circuit over the budget would run on the host: serve refuses it
    monkeypatch.setattr(config.performance, "gates_device_budget", 0)
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(["--mode", "serve", "--gates", "dnf", "--device", "cpu",
                  *SMALL])
    assert str(err.value) == cli._GATES_ON_HOST
    assert "gates_device_budget" in str(err.value)


def _jax_refusal(argv, tmp_path) -> str:
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--root_dir", str(tmp_path)])
    return str(err.value)


@pytest.mark.parametrize("argv", [
    ["--mode", "compile", "--remat"],
    ["--mode", "compile", "--gates", "cnf"],
    ["--mode", "compile", "--ema", "0.9"],
    ["--mode", "compile", "--label_smooth", "0.1"],
    ["--mode", "compile", "--grad_accum", "2"],
    ["--mode", "compile", "--fold_bn"],
    ["--mode", "compile", "--tp"],
    ["--mode", "compile", "--attack", "fgsm"],
    ["--mode", "eval", "--verilog"],
    ["--mode", "serve", "--verilog"],
    ["--mode", "eval", "--gates", "dnf", "--lut"],
    ["--mode", "serve", "--gates", "dnf", "--lut"],
], ids=lambda a: "_".join(x.strip("-") for x in a[1:]))
def test_refusals_are_the_jax_messages(argv, tmp_path):
    want = _jax_refusal(argv + SMALL, tmp_path)
    with pytest.raises(ValueError) as err:
        cli.main(argv + SMALL + ["--device", "cpu"])
    assert str(err.value) == want
