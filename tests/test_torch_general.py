"""The TT_general float family and its correctBN twins
(``models/ttnet_general_float.py``) against the JAX package on the CPU.

f64 logits of ``TT_general`` at 224x224 (p = 4), of ``TT_general_big``,
``TT_general_8``, the 30-layer table with ``a_bit = 1`` and a head
disabled through the tuple form of ``groups`` at 64x64, and of
``TT_general_correctBN`` (224x224) and ``TT_general_correctBN_cifar``
(p = 12) match to 1e-9; two f64 train steps of ``TT_general`` (32x32)
match ``make_train_step`` to 1e-9; a reference-layout ``.pth`` of each
goes through the port's copy of the JAX key map as through the JAX one,
and ``--ckpt`` loads it; ``main`` evaluates, trains and serves
``TT_general`` from ``--model_arg image_size=64`` shards.
"""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, few_threads, images, \
    jax_train_steps, port_and_trees, x64  # noqa: F401
from test_torch_cifar_zoo import assert_trees_match
from test_torch_v1_models import _serve

from scale_imagenet_tpu.convert import torch_import as jimport
from scale_imagenet_tpu.models import get_model as jget
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.convert import torch_import as pimport
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

TOL = dict(rtol=1e-9, atol=1e-9)
P4 = dict(nfilter=2, tfilter=2)
P12 = dict(nfilter=2, tfilter=6)
# TT_general at 224^2; its other variants at 64^2 (``image_size``: their
# crops reconcile to the smallest head at any size, and TT_general_8's
# stride-1 stem keeps 224^2 through its first block)
S64 = dict(P4, image_size=64)
CASES = [("TT_general", P4, 224), ("TT_general_big", S64, 64),
         ("TT_general_8", S64, 64),
         ("TT_general", dict(S64, layers=30, a_bit=1), 64),
         ("TT_general", dict(S64, groups=(1, None, 4, None)), 64),
         ("TT_general_correctBN", P12, 224),
         ("TT_general_correctBN_cifar", P12, 32)]

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("name,kw,size", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_logits_match_jax_f64(x64, name, kw, size):  # noqa: F811
    jm, params, state, md, model = port_and_trees(name, seed=2, **kw)
    x = images((1, size, size, 3), 3) * 2 - 1
    fwd = jax.jit(lambda p, s, a: jm.apply(p, s, a)[0])
    want = np.asarray(fwd.lower(params, state, x).compile(_FAST_COMPILE)(
        params, state, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, md.config.num_classes)
    np.testing.assert_allclose(got, want, **TOL)


def test_two_train_steps_match_jax(x64):  # noqa: F811
    opt_kw = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
    jm, params, state, md, model = port_and_trees(
        "TT_general", seed=5, image_size=32, **P4)
    rng = np.random.default_rng(6)
    batches = [(rng.uniform(-1, 1, (4, 32, 32, 3)),
                rng.integers(0, 1000, 4).astype(np.int32))
               for _ in range(2)]
    tx, _ = jmake_optimizer(**opt_kw)
    jparams, jstate, jmetrics, _ = jax_train_steps(jm, tx, params, state,
                                                   batches)
    opt, _ = make_optimizer(**opt_kw)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for (x, y), want in zip(batches, jmetrics):
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y))
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, **TOL, err_msg=k)
    got_p, got_s = jax_trees(ts.model)
    assert_trees_match(got_p, jparams)
    assert_trees_match(got_s, jstate)
    assert not np.array_equal(got_p["stem_conv"]["weight"],
                              params["stem_conv"]["weight"])


def reference_sd(params: dict, state: dict, cfg) -> dict:
    """The reference's ``features`` layout of a float-family or correctBN
    model, as ``import_tt_general_float`` reads it (the JAX trees'
    inverse)."""
    sd = {}

    def leaf(key, a):
        a = np.asarray(a)
        sd[key] = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 \
            else a.T if a.ndim == 2 else a

    def module(prefix, p, s):
        for k, v in p.items():
            if isinstance(v, dict):
                module(f"{prefix}.{k}", v, s.get(k, {}))
            else:
                leaf(f"{prefix}.{k}", v)
        for k, v in s.items():
            if not isinstance(v, dict):
                leaf(f"{prefix}.{k}", v)

    correctbn = not hasattr(cfg, "variant")
    off = 0 if correctbn or cfg.variant == "general_8" else 1
    module(f"features.{off}", params["stem_conv"], {})
    module(f"features.{off + (1 if correctbn else 2)}", params["stem_bn"],
           state["stem_bn"])
    nb = len(cfg.block_configs())
    names = {"convf": "Block_convf",
             **{f"conv{j}": f"Block_conv{j}" for j in (1, 2, 3, 4)}}
    for i in range(nb):
        for k, v in params[f"block{i}"].items():
            module(f"features.{off + 3 + i}.{names[k]}", v,
                   state[f"block{i}"][k])
    lin = off + 3 + nb + 2
    if correctbn:
        module(f"features.{lin}", params["fc1"], {})
        module(f"features.{lin + 1}", params["fc2"], {})
    else:
        module(f"features.{lin}", params["fc"], {})
    return sd


@pytest.mark.parametrize("name,kw", [("TT_general_big", P4),
                                     ("TT_general_8", P4),
                                     ("TT_general_correctBN_cifar", P12)])
def test_reference_pth_through_the_key_map(tmp_path, name, kw):
    _, params, state, md, model = port_and_trees(name, np.float32, seed=4,
                                                 **kw)
    sd = reference_sd(params, state, md.config)
    want = jimport.import_tt_general_float(
        {f"module.{k}": v for k, v in sd.items()}, jget(name, **kw).config)
    got = pimport.import_tt_general_float(sd, md.config)
    # the JAX importer leaves a fourth head out (ROADMAP.md queue C)
    heads4 = [f"block{i}" for i in range(len(md.config.block_configs()))
              if "conv4" in params[f"block{i}"]]
    assert bool(heads4) == (name == "TT_general_big")
    for g, w in zip(got, want):
        for b in heads4:
            assert "conv4" not in w[b]
            w[b]["conv4"] = g[b]["conv4"]
        assert_trees_match(g, w, rtol=0, atol=0)
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    fresh = get_model(name, **kw).init(seed=9, device="cpu")
    cli.load_checkpoint(fresh, path, name)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items() if "Block_convf" not in k}, path)
    # the float cells' heads are optional in the map: a missing one is
    # found by the check of the imported tree, as in the JAX CLI
    with pytest.raises(ValueError, match="does not match the .* "
                                         "architecture|is missing params"):
        cli.load_checkpoint(fresh, path, name)


def test_main_eval_train_serve(tmp_path):
    rng = np.random.default_rng(7)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8),
        rng.integers(0, 1000, 5).astype(np.int32)), str(tmp_path / "s"))
    base = ["--model", "TT_general", "--nfilter", "2", "--tfilter", "2",
            "--layers", "18", "--model_arg", "image_size=64", "--device",
            "cpu", "--root_dir", str(tmp_path / "run")]
    with redirect_stdout(io.StringIO()):
        top1, top5, loss = cli.main(["--mode", "eval", *base, "--shards_dir",
                                     str(tmp_path / "s"),
                                     "--eval_batch_size", "4"])
        summary = cli.main(["--mode", "train", *base, "--shards_dir",
                            str(tmp_path / "s"), "--train_batch_size", "2",
                            "--max_epochs", "1"])
    assert np.isfinite(loss) and 0 <= top1 <= top5 <= 100
    assert summary["step"] == 2 and all(np.isfinite(r[1])
                                        for r in summary["train"])
    model = get_model("TT_general", image_size=64, layers=18,
                      **P4).init(device="cpu")
    xs = (images((2, 64, 64, 3), 8) * 2 - 1).astype(np.float32)
    with torch.no_grad():
        direct = torch.topk(torch.softmax(model(torch.from_numpy(xs)), -1),
                            5).indices
    assert _serve(base, xs) == direct.tolist()
