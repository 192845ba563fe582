"""The registry and the CLI of the zoo families (the port's
``models/registry.py`` and ``main.py``) against the JAX package's.

``list_models()`` equals the JAX registry's 71 names; each of the 34 names
this slice adds builds the JAX factory's config (field for field) and loads
the JAX init's trees strictly (shapes from ``jax.eval_shape``, the module
on the meta device) with an equal parameter count, the deep ResNets
included. ``--model_arg`` parses as the JAX CLI parses it. Each refusal the
JAX CLI gives these families (``--lut``, ``--gates``, ``--mode export``,
``--fold_bn`` outside the ResNets, ``--fuse_quant`` outside them, at ``wbit
= 32``, with ``--fold_bn`` or ``--lut``, and ``--ckpt X.pth`` of
``tt_certif``) has its text; where ``--mode compile`` crashes in the JAX
CLI the port's ``ValueError`` carries the JAX error's text. The JAX CLI
runs there with zero weights of its init's shapes (``jax.eval_shape``; the
texts depend on the structure alone): its op-by-op init takes seconds a
model. ``main`` evaluates a ResNet plain, ``--fold_bn`` and
``--fuse_quant``, trains it from shards and serves it.
"""

import dataclasses
import io
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads, images, \
    jax_cli_refusal  # noqa: F401
from test_torch_v1_models import _serve

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.models import get_model as jget, \
    list_models as jlist
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import state_dict_from_jax
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.models import get_model, list_models
from scale_imagenet_tpu_torch.models.registry import ZOO_MODULES

NEW = [n for n in list_models() if type(get_model(n).config) in ZOO_MODULES]

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def test_list_models_equals_jax():
    assert list_models() == jlist()
    assert len(list_models()) == 71 and len(NEW) == 34


@pytest.mark.parametrize("name", NEW)
def test_new_name_builds_and_loads_jax_trees_strict(name):
    jm, md = jget(name), get_model(name)
    assert md.name == jm.name
    assert dataclasses.asdict(md.config) == dataclasses.asdict(jm.config)
    params, state = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    with torch.device("meta"):
        model = ZOO_MODULES[type(md.config)](md.config)
    model.load_state_dict(state_dict_from_jax(params, state, md.config),
                          strict=True, assign=True)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize("pairs", [
    ["wbit=2", "abit=8"], ["groups=1,None,4,None"], ["head=binpos_v2"],
    ["quant_step=0.125", "remove_last_bn=true", "dataset=MNIST"],
    ["filters=48,32", "type_weights_final=float", "x="]])
def test_model_arg_parses_as_jax(pairs):
    assert cli.parse_model_args(pairs) == jmain._parse_model_args(pairs)
    with pytest.raises(SystemExit, match="KEY=VALUE"):
        cli.parse_model_args(["novalue"])


SMALL = {"TT_general": ["--nfilter", "2", "--tfilter", "2"],
         "TT_general_correctBN_cifar": ["--nfilter", "2", "--tfilter", "6"],
         "tt_certif": ["--nfilter", "1", "--tfilter", "3"]}


def _zero_params(cfg, model):
    """The JAX CLI's ``load_params`` without a checkpoint, as zeros."""
    if cfg.ckpt is not None:
        return real_load_params(cfg, model)
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        jax.eval_shape(model.init, jax.random.PRNGKey(0)))


real_load_params = jmain.load_params


def jax_refusal(argv: list, root: str) -> BaseException:
    with mock.patch.object(jmain, "load_params", _zero_params):
        return jax_cli_refusal(argv, root)


def _refusals(name: str, tmp) -> list:
    """``(JAX argv, port-only argv)`` pairs this family refuses."""
    w = SMALL.get(name, [])
    model = ["--model", name, *w]
    shards = ["--shards_dir", str(tmp / "none")]
    return [["--mode", "compile", *model, "--compile_out", str(tmp / "c")],
            ["--mode", "export", *model, "--export_out",
             str(tmp / "e.pth")],
            ["--mode", "eval", *model, *shards, "--lut"],
            ["--mode", "eval", *model, *shards, "--gates", "dnf"],
            ["--mode", "eval", *model, *shards, "--fuse_quant"],
            ["--mode", "eval", *model, *shards, "--fold_bn"]]


FAMILIES = ["TT_general", "TT_general_correctBN_cifar",
            "mobilenet_v2_tt_32_32", "mobilenet_v1_tt", "model_general",
            "cifar10lownoise", "tt_certif", "resnet18_cifar"]


@pytest.mark.parametrize("name", FAMILIES)
def test_refusals_and_crashes_match_jax(tmp_path, name):
    for argv in _refusals(name, tmp_path):
        if name == "resnet18_cifar" and argv[-1] in ("--fuse_quant",
                                                     "--fold_bn"):
            continue                       # the family's own transforms
        want = jax_refusal(argv, str(tmp_path / "jax"))
        with pytest.raises(ValueError) as got, \
                redirect_stdout(io.StringIO()):
            cli.main(argv + ["--device", "cpu", "--root_dir",
                             str(tmp_path / "run")])
        if argv[1] == "compile":
            # the JAX CLI's compiler crashes, or its enumerator refuses,
            # inside: the port names that error
            assert str(want) in str(got.value), (argv, want)
        else:
            assert isinstance(want, ValueError) and \
                str(got.value) == str(want), argv


@pytest.mark.parametrize("argv", [
    ["--model_arg", "wbit=32", "--fuse_quant"],
    ["--fuse_quant", "--fold_bn"], ["--fuse_quant", "--lut"],
    ["--fuse_quant", "--gates", "cnf"]])
def test_fuse_quant_refusals_match_jax(tmp_path, argv):
    base = ["--mode", "eval", "--model", "resnet18_cifar", "--shards_dir",
            str(tmp_path / "none"), *argv]
    want = jax_refusal(base, str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(base + ["--device", "cpu"])
    assert str(got.value) == str(want)


def test_ckpt_pth_refusal_matches_jax(tmp_path):
    path = str(tmp_path / "ref.pth")
    torch.save({"features.0.weight": torch.zeros(3)}, path)
    argv = ["--mode", "eval", "--model", "tt_certif", "--nfilter", "1",
            "--tfilter", "3", "--shards_dir", str(tmp_path / "none"),
            "--ckpt", path]
    want = jax_refusal(argv, str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want)


def test_resnet_main_eval_fold_fuse_train_serve(tmp_path):
    rng = np.random.default_rng(2)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, 5).astype(np.int32)), str(tmp_path / "s"))
    base = ["--model", "resnet18_cifar", "--model_arg", "num_classes=10",
            "--device", "cpu", "--root_dir", str(tmp_path / "run")]
    ev = ["--mode", "eval", *base, "--shards_dir", str(tmp_path / "s"),
          "--eval_batch_size", "4"]
    with redirect_stdout(io.StringIO()):
        plain = cli.main(ev)
        fused = cli.main(ev + ["--fuse_quant"])
        folded = cli.main(ev + ["--model_arg", "wbit=32", "--fold_bn"])
        summary = cli.main(["--mode", "train", *base, "--shards_dir",
                            str(tmp_path / "s"), "--train_batch_size", "2",
                            "--max_epochs", "1"])
    for top1, top5, loss in (plain, fused, folded):
        assert np.isfinite(loss) and 0 <= top1 <= top5 <= 100
    # the fused-quant forward is the plain one up to float rounding
    assert fused[0] == plain[0] and abs(fused[2] - plain[2]) < 1e-4
    assert summary["step"] == 2
    # served at the JAX CLI's side for a config that names none, 224: the
    # ImageNet stem's ResNet (the CIFAR one at 224^2 costs the CPU
    # seconds a batch)
    serve = ["--model", "resnet18", "--model_arg", "num_classes=10",
             "--device", "cpu", "--root_dir", str(tmp_path / "run")]
    model = get_model("resnet18", num_classes=10).init(device="cpu")
    xs = (images((2, 224, 224, 3), 8) * 2 - 1).astype(np.float32)
    with torch.no_grad():
        direct = torch.topk(torch.softmax(model(torch.from_numpy(xs)), -1),
                            5).indices
    assert _serve(serve, xs) == direct.tolist()
