"""The port's VGG16-stem TTnet (``TT_vf_19lv3_imgnet_xsmall_VGG``) against
the JAX package, at its full width (p = 64, 224x224 inputs, fcsize 36,864)
on the CPU: one JAX init feeds both sides through ``convert/from_jax.py``.

Tolerances: f64 conv logits to 1e-9 (summation order only); truth tables,
packed words, covers and every block bit exactly; LUT and gate logits
against JAX's to 1e-4 in f32 (the blocks are bit-exact, the float stem
and classifier sum in another order), and the port's gate forward equal
to its LUT forward.
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, nchw, x64  # noqa: F401
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu import compile as jcompile
from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.compile import gate_device as jdev
from scale_imagenet_tpu.compile import gate_net as jgate
from scale_imagenet_tpu.compile import lut_eval as jlut
from scale_imagenet_tpu.convert.torch_import import import_ttnet_vgg_stem
from scale_imagenet_tpu.layers.pool import max_pool as jmax_pool
from scale_imagenet_tpu.models import multihead as jmh
from scale_imagenet_tpu.models.ttnet_imagenet import \
    ttnet_vgg_stem_apply as japply
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.compile import gate_device, gate_net, \
    lut_eval, lut_store, truth_table
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
from scale_imagenet_tpu_torch.kernels import lut_gather as K
from scale_imagenet_tpu_torch.layers.pool import max_pool
from scale_imagenet_tpu_torch.models import get_model, list_models, \
    multihead
from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, \
    ttnet_vgg_stem_apply, vgg_stem

NAME = "ttnet_imagenet_vgg_stem"
VGG = ["--model", NAME]
TOL = dict(rtol=1e-9, atol=1e-9)


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def vgg32():
    """One f32 JAX init on both sides (BN statistics perturbed), with each
    side's compiled tables and gate nets."""
    jm, params, state, md, model = jax_and_port(NAME, np.float32, seed=4,
                                                jit=True)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)
    return dict(jm=jm, params=params, state=state, jp=jp, js=js, md=md,
                model=model,
                jluts=jlut.compile_ttnet_lut(jp, js, jm.config),
                luts=lut_eval.compile_ttnet_lut(model),
                jnets=jgate.compile_ttnet_gates(params, state, jm.config),
                pnets=gate_net.compile_ttnet_gates(model))


def test_registry_config_and_layout():
    from scale_imagenet_tpu.models import get_model as jget

    assert {NAME, "TT_vf_19lv3_imgnet_xsmall_VGG"} <= set(list_models())
    for name in (NAME, "TT_vf_19lv3_imgnet_xsmall_VGG"):
        md, jm = get_model(name), jget(name)
        assert md.name == jm.name == "TT_vf_19lv3_imgnet_xsmall_VGG"
        assert md.config.feature_shape() == jm.config.feature_shape() \
            == (12, 12, 256)
        assert md.config.fcsize == jm.config.fcsize == 36_864
    model = get_model(NAME, num_classes=10).init(device="cpu")
    assert model.classifier.lin1.weight.shape == (1000, 36_864)
    assert model.classifier.lin2.weight.shape == (10, 1000)
    block = model.blocks[0]
    assert block.Block_convf is None and block.cfg.out_channels == 256
    names = set(model.state_dict())
    assert {"features.1.weight", "features.1.bias", "features.3.weight",
            "features.3.bias", "features.5.running_var",
            "features.7.grad_scale", "features.8.Block_conv3.conv1.weight",
            "features.8.act.grad_scale", "features.10.lin1.weight",
            "features.10.BN2.weight", "features.10.lin2.bias"} <= names
    assert not [k for k in names if "Block_convf" in k]


def test_state_dict_round_trips_and_imports_in_jax(vgg32):
    """``state_dict_from_jax`` loads strict (the fixture), ``jax_trees``
    gives the JAX trees back, JAX's reference importer reads the port's
    state dict into the same trees, and the LUT digests agree."""
    params, state, model = vgg32["params"], vgg32["state"], vgg32["model"]
    p2, s2 = jax_trees(model)
    for a, b in ((p2, params), (s2, state)):
        flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert [k for k, _ in flat_a] == list(flat_b)
        for k, v in flat_a:
            np.testing.assert_array_equal(v, flat_b[k])
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ip, istate = import_ttnet_vgg_stem(sd, vgg32["jm"].config)
    for a, b in ((ip, params), (istate, state)):
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, a), b)
    assert lut_store.model_digest(model) == jcompile.params_digest(params,
                                                                  state)


def test_max_pool_and_fixup_match_jax():
    x = images((2, 56, 56, 3), 1).astype(np.float32)
    got = max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 5)
    np.testing.assert_array_equal(nchw(got), np.asarray(jmax_pool(
        jnp.asarray(x), 5)))
    assert got.shape[2:] == (11, 11)
    for xw in (56, 29, 16, 15, 11, 9, 8):
        for out1w in (xw, xw + 1, 6, 58):
            assert multihead.FIXUP_RULES["v2small_alexnet"](xw, out1w) == \
                jmh.FIXUP_RULES["v2small_alexnet"](xw, out1w)
    kw = dict(in_planes=64, out_planes=64, k12=(2, 2), pad12=(1, 1),
              groups=(1, 1, 4, 1), groupvf=4, fixup="v2small_alexnet")
    for fuse in (True, False):
        cfg = multihead.MultiHeadConfig(**kw, fuse=fuse)
        jcfg = jmh.MultiHeadConfig(**kw, fuse=fuse)
        assert cfg.out_channels == jcfg.out_channels
        for s in (11, 56):
            assert multihead.multihead_out_size(cfg, s, s) == \
                jmh.multihead_out_size(jcfg, s, s)


def test_conv_logits_match_jax_f64(x64):
    """Logits to 1e-9 and the stem's and the block's bits exactly at 224^2,
    where the 11x11 input fires the fixup's ``x == 11`` row."""
    jm, params, state, md, model = jax_and_port(NAME, np.float64, seed=5,
                                                jit=True)
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    x = images((2, 224, 224, 3), 7)
    ref, _ = jax.jit(japply, static_argnums=2)(jp, js, jm.config,
                                                jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = ttnet_vgg_stem_apply(model, xt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        bits = vgg_stem(model, _nchw(xt, model))
        out = model.blocks[0](bits)
    assert bits.shape == (2, 64, 11, 11) and 0.05 < float(bits.mean()) < 0.95
    jbits = jax.jit(lambda h: jmh.multihead_block(
        jp["block0"], js["block0"], jm.config.block_config(), h)[0])(
        jnp.asarray(nchw(bits)))
    assert out.shape == (2, 256, 12, 12)
    np.testing.assert_array_equal(nchw(out), np.asarray(jbits))


def test_tables_and_words_match_jax(vgg32):
    """Each head's table and packed words equal ``compile_ttnet_lut``'s;
    there is no fuse table."""
    (jl,), (tl,) = vgg32["jluts"], vgg32["luts"]
    assert jl.convf is None and tl.convf is None
    for i, h in tl.heads.items():
        assert h.cfg.n_bits == 4
        np.testing.assert_array_equal(
            h.packed.numpy(),
            np.asarray(jl.heads[i].packed).reshape(h.packed.shape))
        np.testing.assert_array_equal(
            lut_store._table(h).numpy(), np.asarray(jl.heads[i].table))
    # heads 1 and 2 share one launch, head 3 takes another
    assert [ids for ids, _ in tl.merged] == [(1, 2), (3,)]


def test_lut_forward_matches_jax_and_conv(vgg32, monkeypatch):
    """The LUT logits against JAX's ``lut_ttnet_vgg_stem_apply`` (its plain
    gather on the CPU) and against the port's conv forward; two window
    launches a forward (merged heads 1+2 at k=2, head 3 at k=1)."""
    model = vgg32["model"]
    x = images((2, 224, 224, 3), 8).astype(np.float32)
    ref = jlut.lut_ttnet_vgg_stem_apply(vgg32["jluts"], vgg32["jp"],
                                        vgg32["js"], vgg32["jm"].config,
                                        jnp.asarray(x))
    calls = []
    real = lut_eval.lut_window_bits
    monkeypatch.setattr(lut_eval, "lut_window_bits",
                        lambda *a, **k: calls.append(
                            (*a[2:], k.get("heads", 1))) or real(*a, **k))
    K.reset_launches()
    xt = torch.from_numpy(x)
    got = lut_eval.lut_ttnet_vgg_stem_apply(vgg32["luts"], model, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    with torch.no_grad():
        conv = ttnet_vgg_stem_apply(model, xt)
    torch.testing.assert_close(got, conv, rtol=1e-4, atol=1e-4)
    # (k, stride, padding, heads)
    assert calls == [(2, 1, 1, 2), (1, 1, 0, 1)]
    assert K.lut_window_bits.launches == 0            # CPU: no kernel


def test_gate_covers_and_bits_match_jax_and_lut(vgg32):
    """Covers and gate counts equal JAX's; the host and device circuits'
    block bits equal JAX's host circuit and the port's LUT block; the
    logits equal the LUT forward's exactly and JAX's to 1e-4."""
    jnets, pnets, model = vgg32["jnets"], vgg32["pnets"], vgg32["model"]
    (jm_,), (pm,) = jnets, pnets
    assert pm.convf is None and jm_.convf is None
    assert gate_net.total_gates(pnets) == jgate.total_gates(jnets) > 0
    for i, bg in pm.heads.items():
        jb = jm_.heads[i]
        assert bg.gates == jb.gates and bg.constants == jb.constants
        for a, b in zip(bg.covers + bg.cnf_covers, jb.covers + jb.cnf_covers):
            np.testing.assert_array_equal(a, np.asarray(b, np.uint32))
    x = images((2, 224, 224, 3), 9).astype(np.float32)
    xt = torch.from_numpy(x)
    h = lut_eval._bits(vgg_stem(model, _nchw(xt, model)), None)
    want = lut_eval.lut_multihead_apply(vgg32["luts"][0], h)
    jh = jnp.asarray(nchw(h))
    lut_logits = lut_eval.lut_ttnet_vgg_stem_apply(vgg32["luts"], model, xt)
    GC.reset_launches()
    for form in ("dnf", "cnf"):
        host = gate_net.gate_multihead_apply(pm, h, form=form)
        gdevs = gate_device.build_device_gates(pnets, form)
        dev = gate_device.gate_multihead_apply_device(gdevs[0], h)
        jout = jgate.gate_multihead_apply(jm_, jh, form=form)
        assert torch.equal(host, want) and torch.equal(dev, want)
        np.testing.assert_array_equal(nchw(host), np.asarray(jout))
        got = gate_device.gate_ttnet_vgg_stem_apply_device(gdevs, model, xt)
        assert torch.equal(got, lut_logits)
        assert torch.equal(gate_net.gate_ttnet_vgg_stem_apply(
            pnets, model, xt, form=form), lut_logits)
        jlogits = jgate.gate_ttnet_vgg_stem_apply(
            jnets, vgg32["jp"], vgg32["js"], vgg32["jm"].config,
            jnp.asarray(x), form=form)
        np.testing.assert_allclose(got.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        jdevs = jdev.build_device_gates(jnets, form)
        jlogits_dev = jdev.gate_ttnet_vgg_stem_apply_device(
            jdevs, vgg32["jp"], vgg32["js"], vgg32["jm"].config,
            jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlogits_dev),
                                   rtol=1e-4, atol=1e-4)
    assert GC.gate_cubes.launches == 0               # CPU: no kernel


def test_lut_archives_load_in_both_packages(vgg32, tmp_path):
    model, jm = vgg32["model"], vgg32["jm"]
    params, state = vgg32["params"], vgg32["state"]
    ours = str(tmp_path / "port.npz")
    lut_store.save_luts(ours, vgg32["luts"], model)
    with np.load(ours) as data:
        assert not [k for k in data.files if "convf" in k]
    (got,) = jcompile.load_luts(ours, jm.config, params, state)
    assert got.convf is None
    for i, h in vgg32["jluts"][0].heads.items():
        np.testing.assert_array_equal(np.asarray(got.heads[i].table),
                                      np.asarray(h.table))
        np.testing.assert_array_equal(np.asarray(got.heads[i].packed),
                                      np.asarray(h.packed))
    theirs = str(tmp_path / "jax.npz")
    jcompile.save_luts(theirs, vgg32["jluts"], params, state)
    (loaded,) = lut_store.load_luts(theirs, model)
    assert loaded.convf is None
    for i, h in vgg32["luts"][0].heads.items():
        assert torch.equal(loaded.heads[i].packed, h.packed)


def _vgg_shards(tmp_path, n=4):
    """``n`` seeded 224^2 uint8 images with labels, and the port model's
    weights (seed 3, BN statistics moved) as a reference-layout ``.pth``
    that also holds the dead fuse head's keys, as a reference export
    does."""
    rng = np.random.default_rng(21)
    u8 = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    write_shards(ArrayDataset(u8, rng.integers(0, 10, n).astype(np.int32)),
                 str(tmp_path / "shards"))
    model = get_model(NAME).init(seed=3, device="cpu")
    with torch.no_grad():
        model.stem_bn.running_mean.add_(0.3)
    sd = dict(model.state_dict())
    sd["features.8.Block_convf.conv1.weight"] = torch.zeros(2048, 4, 1, 1)
    path = str(tmp_path / "w.pth")
    torch.save({"model_state_dict": sd}, path)
    return str(tmp_path / "shards"), path, model


def test_cli_eval_conv_lut_and_gates(tmp_path):
    """``--mode eval`` on the VGG stem as conv, ``--lut --lut_path``
    (writing, then loading the archive) and ``--gates dnf|cnf``: the
    compiled forwards' metrics equal each other, and the conv's top-1
    and top-5."""
    shards, ckpt, _ = _vgg_shards(tmp_path)
    base = ["--mode", "eval", "--device", "cpu", "--shards_dir", shards,
            "--eval_batch_size", "3", "--ckpt", ckpt, "--root_dir",
            str(tmp_path), *VGG]
    lut = ["--lut", "--lut_path", str(tmp_path / "luts.npz")]
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


def test_cli_serve_conv(tmp_path):
    """``--mode serve`` on the VGG stem as its conv forward: the answers'
    top-5 equal the direct forward's."""
    import threading
    import urllib.request

    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            with redirect_stdout(io.StringIO()):
                cli.main(["--mode", "serve", "--device", "cpu", "--port",
                          "0", "--serve_batch", "2", "--seed", "6", *VGG],
                         serve_ready=ready, serve_stop=stop)
        except Exception as e:                  # surfaced below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    xs = images((2, 224, 224, 3), 15).astype(np.float32)
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
    model = get_model(NAME).init(seed=6, device="cpu")
    with torch.no_grad():
        logits = ttnet_vgg_stem_apply(model, torch.from_numpy(xs))
    assert answers == torch.topk(torch.softmax(logits, -1), 5).indices \
        .tolist()


def test_cli_compile_verilog_matches_jax(tmp_path):
    """``--mode compile --verilog`` on the VGG stem: no ``convf`` item, and
    ``summary.json`` byte-identical to the JAX CLI's from the same
    ``.pth``."""
    _, ckpt, model = _vgg_shards(tmp_path, n=1)
    outs = {}
    for tag, entry, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jmain.main, [])):
        out = str(tmp_path / tag)
        with redirect_stdout(io.StringIO()):
            entry(["--mode", "compile", "--verilog", "--ckpt", ckpt,
                   "--compile_out", out, "--root_dir", str(tmp_path),
                   *VGG, *extra])
        outs[tag] = out
    with open(os.path.join(outs["port"], "summary.json"), "rb") as f:
        ours = f.read()
    with open(os.path.join(outs["jax"], "summary.json"), "rb") as f:
        assert ours == f.read()
    summary = json.loads(ours)
    assert sorted(summary["blocks"]) == ["block0_conv1", "block0_conv2",
                                         "block0_conv3"]
    manifest = json.load(open(os.path.join(outs["port"], "verilog",
                                           "manifest.json")))
    assert manifest["total_gates"] == gate_net.total_gates(
        gate_net.compile_ttnet_gates(model))
    assert [n for n, _ in truth_table.model_block_items(model)] == \
        sorted(summary["blocks"])


def _jax_refusal(argv, tmp_path) -> str:
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--root_dir", str(tmp_path)])
    return str(err.value)


@pytest.mark.parametrize("argv", [
    ["--mode", "eval", "--shards_dir", "d", "--fold_bn"],
    ["--mode", "serve", "--fold_bn"],
    ["--mode", "export"],
], ids=["eval_fold_bn", "serve_fold_bn", "export"])
def test_vgg_refusals_are_the_jax_messages(argv, tmp_path):
    """``--fold_bn`` knows the ttnet_imagenet pairing only, and export the
    ttnet_imagenet family only: the VGG stem is refused with JAX's text."""
    want = _jax_refusal(argv + VGG + ["--mesh_data", "1", "--export_out",
                                      str(tmp_path / "j.pth")], tmp_path)
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + VGG + ["--device", "cpu", "--export_out",
                               str(tmp_path / "p.pth")])
    assert str(err.value) == want
    assert "TTnetVGGStemConfig" in want


def test_vgg_train_names_the_roadmap(tmp_path):
    """The VGG stem trains now (``tests/test_torch_vgg_train.py``): its
    ``--remat`` is refused with the JAX CLI's text, and so is robust
    training with a label-smoothed loss."""
    shards, _, _ = _vgg_shards(tmp_path, n=1)
    argv = ["--mode", "train", "--shards_dir", shards, "--remat", *VGG]
    want = _jax_refusal(argv, tmp_path)
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu", "--root_dir", str(tmp_path)])
    assert str(err.value) == want and "TTnetVGGStemConfig" in want
    argv = ["--mode", "train", "--shards_dir", shards, "--stability_eps",
            "0.1", "--label_smooth", "0.1", *VGG]
    want = _jax_refusal(argv, tmp_path)
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu", "--root_dir", str(tmp_path)])
    assert str(err.value) == want and "robust steps" in want
