"""The port's training slice against the JAX package: the Heaviside STE
backward, training BatchNorm, the train step (plain, ``accum``,
``label_smooth``, EMA, remat, amp), the LR schedules, checkpoints and
resume, and ``main --mode train`` end to end on the CPU.

One JAX init is carried to the port through ``state_dict_from_jax``; two
consecutive steps (momentum and weight decay act, and an LR milestone falls
between them) from the same seeded numpy batches give the same loss,
top-1/5, parameters and BN running statistics to 1e-9 relative in f64,
compared through ``jax_trees``.  Each JAX step variant is compiled once per
module (``jax_ref``): the compiles are most of this file's time.
"""

import copy
import dataclasses
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import images, jax_and_port, jax_train_steps
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu.layers.norm import batch_norm as jbatch_norm
from scale_imagenet_tpu.ops.binarize import heaviside01 as jheaviside01
from scale_imagenet_tpu.runtime import checkpoint as jcheckpoint
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu.train.optim import params_ema as jparams_ema
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.layers.norm import batch_norm
from scale_imagenet_tpu_torch.ops.binarize import heaviside01
from scale_imagenet_tpu_torch.runtime.checkpoint import CheckpointManager, \
    load_train_state, train_payload
from scale_imagenet_tpu_torch.train import TrainState, get_ema, \
    make_optimizer, make_train_step, params_ema

MODEL = dict(nfilter=4, tfilter=4, layers=0, image_size=64)
SMALL = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter",
         "4", "--layers", "0"]
B = 4
# lr 0.1 for the first update, 0.01 for the second
OPT = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
# the plain step, and the README's recipe: two microbatches, label smoothing
# and a params EMA in one step (each JAX variant is one compile)
VARIANTS = {"plain": ({}, None),
            "accum2_smooth_ema": ({"accum": 2, "label_smooth": 0.1}, 0.9)}


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def setup(x64_module):
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_xsmall", np.float64, jit=True, **MODEL)
    rng = np.random.default_rng(1)
    batches = [(images((B, 64, 64, 3), s),
                rng.integers(0, 1000, B).astype(np.int32)) for s in (11, 12)]
    return jm, params, state, model, batches


@pytest.fixture(scope="module")
def jax_ref(setup):
    """``jax_ref(variant)``: the JAX package's two steps, compiled once."""
    jm, params, state, _, batches = setup
    cache = {}

    def get(name):
        if name not in cache:
            kw, ema = VARIANTS[name]
            tx, _ = jmake_optimizer(**OPT)
            if ema:
                tx = optax.chain(tx, jparams_ema(ema))
            cache[name] = jax_train_steps(jm, tx, params, state, batches,
                                          **kw)
        return cache[name]
    return get


def port_steps(model0, batches, kw=None, ema=None, remat=False,
               dtype=torch.float64):
    """The port's steps from a copy of ``model0``: ``(ts, metrics)``."""
    model = copy.deepcopy(model0).to(dtype)
    if remat:
        model.cfg = dataclasses.replace(model.cfg, remat=True)
    opt, _ = make_optimizer(**OPT)
    if ema:
        opt = dataclasses.replace(opt, ema=params_ema(ema))
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt, **(kw or {}))
    metrics = []
    for x, y in batches:
        ts, m = step(ts, torch.from_numpy(x).to(dtype), torch.from_numpy(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return ts, metrics


def assert_trees_close(got, want, rtol=1e-9, atol=1e-12):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_steps_match_jax(setup, jax_ref, variant):
    """Loss, top-1/5, every parameter and BN running statistic (and the EMA
    tree) after two steps, against ``make_train_step``."""
    *_, model0, batches = setup
    jparams, jstate, jmetrics, jema = jax_ref(variant)
    kw, ema = VARIANTS[variant]
    ts, metrics = port_steps(model0, batches, kw, ema)
    for got, want in zip(metrics, jmetrics):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-9)
        assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    params, state = jax_trees(ts.model)
    assert_trees_close(params, jparams)
    assert_trees_close(state, jstate)
    assert ts.step == 2
    if ema:
        m = copy.deepcopy(ts.model)
        m.load_state_dict({**m.state_dict(), **get_ema(ts.opt_state)})
        assert_trees_close(jax_trees(m)[0], jema)
    else:
        assert jema is None and get_ema(ts.opt_state) is None


def test_remat_updates_bn_statistics_once(setup):
    """Under remat the backward runs each block's forward again; the loss
    is bit-identical to the plain step's and the running statistics are
    equal, so each was updated once."""
    *_, model0, batches = setup
    plain, pm = port_steps(model0, batches)
    remat, rm = port_steps(model0, batches, remat=True)
    assert pm == rm
    for (name, a), b in zip(plain.model.named_buffers(),
                            remat.model.buffers()):
        assert torch.equal(a, b), name
    for (name, a), b in zip(plain.model.named_parameters(),
                            remat.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-15, msg=name)
    # and a BN statistic did move
    assert not torch.equal(plain.model.stem_bn.running_mean,
                           model0.stem_bn.running_mean.to(torch.float64))


def test_amp_step_against_jax(setup):
    """``amp``: bf16 forward and backward, f32 masters.  The JAX step is
    compiled with XLA's excess precision off, so that each bf16 op rounds
    as the program is written (and as the port's ops do); then the loss
    agrees to 1e-2 relative and the update's cosine is >= 0.99."""
    jm, params, state, model0, batches = setup
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    batch = [(batches[0][0].astype(np.float32), batches[0][1])]
    tx, _ = jmake_optimizer(**OPT)
    jparams, _, jmetrics, _ = jax_train_steps(
        jm, tx, f32(params), f32(state), batch,
        compile_options={"xla_allow_excess_precision": False}, amp=True)
    ts, metrics = port_steps(model0, batch, {"amp": True},
                             dtype=torch.float32)
    assert {t.dtype for t in ts.model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    np.testing.assert_allclose(metrics[0]["loss"], jmetrics[0]["loss"],
                               rtol=1e-2)
    start = jax.tree.leaves(f32(params))
    ours = jax.tree.leaves(jax_trees(ts.model)[0])
    du = np.concatenate([(a - s).ravel() for a, s in zip(ours, start)])
    dv = np.concatenate([(a - s).ravel()
                         for a, s in zip(jax.tree.leaves(jparams), start)])
    cos = du @ dv / (np.linalg.norm(du) * np.linalg.norm(dv))
    assert cos >= 0.99, cos


@pytest.mark.parametrize("scale", [1.0, 0.5, None])
def test_heaviside_ste_backward_matches_jax(x64_module, scale):
    """Forward bits and the surrogate gradient (tanh' at scale s, or the
    hardtanh mask when the scale is None)."""
    x = np.random.default_rng(3).standard_normal(200) * 2
    g = np.random.default_rng(4).standard_normal(200)
    saved = config.numerics.bingrad_soft_tanh_scale
    from scale_imagenet_tpu.config import numerics as jnumerics
    jsaved = jnumerics.bingrad_soft_tanh_scale
    config.numerics.bingrad_soft_tanh_scale = scale
    jnumerics.bingrad_soft_tanh_scale = scale
    try:
        xt = torch.from_numpy(x).requires_grad_()
        out = heaviside01(xt)
        out.backward(torch.from_numpy(g))
        jout, vjp = jax.vjp(lambda a: jheaviside01(a, jnp.ones(())),
                            jnp.asarray(x))
        (jgrad,) = vjp(jnp.asarray(g))
    finally:
        config.numerics.bingrad_soft_tanh_scale = saved
        jnumerics.bingrad_soft_tanh_scale = jsaved
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("shape", [(6, 5), (3, 5, 4, 2)])
def test_training_batch_norm_matches_jax(x64_module, shape):
    """Batch statistics normalise; the running update uses the unbiased
    variance at momentum 0.1 and is returned, not written."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape) * 3 + 1          # NHWC / (N, C)
    c = shape[-1]
    bn = torch.nn.BatchNorm1d(c).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2, c)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(c)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, c)))
    before = bn.running_mean.clone()
    xt = torch.from_numpy(x)
    if xt.dim() == 4:
        xt = xt.permute(0, 3, 1, 2)
    stats = {}
    y = batch_norm(bn, xt, stats)
    if y.dim() == 4:
        y = y.permute(0, 2, 3, 1)
    p = {"weight": bn.weight.detach().numpy(),
         "bias": bn.bias.detach().numpy()}
    s = {"running_mean": before.numpy(),
         "running_var": bn.running_var.numpy()}
    jy, js = jbatch_norm(p, s, jnp.asarray(x), training=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-12, atol=1e-12)
    mean, var = stats[bn]
    np.testing.assert_allclose(mean.numpy(), np.asarray(js["running_mean"]),
                               rtol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(js["running_var"]),
                               rtol=1e-12)
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("schedule,warmup", [("multistep", 0),
                                             ("multistep", 1.5),
                                             ("cosine", 0), ("cosine", 1)])
def test_lr_schedules_match_jax(x64_module, schedule, warmup):
    """Every step of a 3-epoch run at 7 steps an epoch, milestones inside
    it.  The port computes each rate in Python floats.  Where the JAX
    schedule returns f64 the two are equal; its warmup ramps compute in f32
    even under x64 (optax's ``linear_schedule``, the int32 step ratio), and
    there they agree to one f32 rounding."""
    kw = dict(lr=0.4, milestones=(1, 2), steps_per_epoch=7,
              schedule=schedule, max_epochs=3, warmup_epochs=warmup)
    _, ours = make_optimizer(**kw)
    _, theirs = jmake_optimizer(**kw)
    got = np.asarray([ours(t) for t in range(21)])
    want = [theirs(jnp.asarray(t, jnp.int32)) for t in range(21)]
    rtol = 0.0 if want[0].dtype == np.float64 else np.finfo(np.float32).eps
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol,
                               atol=0)
    assert (want[0].dtype == np.float64) == (warmup == 0)
    assert len(set(got.tolist())) > 2


def _pre_crop_batches(n_batches, seed, size=72):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.integers(0, 256, (B, size, size, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 1000, B).astype(np.int32)))
            for _ in range(n_batches)]


def _aug_run(model0, batches, ts=None, start=0, ckpt=None, ema=0.9):
    """Steps of the full on-device recipe (a 72x72 pre-crop to 64x64, the
    generator reseeded from the step) with an EMA, from ``ts`` or fresh."""
    model = ts.model if ts else copy.deepcopy(model0).float()
    opt, _ = make_optimizer(**OPT)
    opt = dataclasses.replace(opt, ema=params_ema(ema))
    if ts is None:
        ts = TrainState(model, opt.init(dict(model.named_parameters())))
        if ckpt:
            cli.load_checkpoint(model, ckpt)
            load_train_state(ckpt, ts)
    step = make_train_step(model, opt, augment="full",
                           normalize=((0.485, 0.456, 0.406),
                                      (0.229, 0.224, 0.225)))
    gen = torch.Generator()
    losses = []
    for x, y in batches[start:]:
        gen.manual_seed(1000 + ts.step)
        ts, m = step(ts, x, y, gen)
        losses.append(float(m["loss"]))
    return ts, losses


def test_resume_equals_straight_run(setup, tmp_path):
    """Two steps, a checkpoint, a resume into a fresh model, two more
    steps: the same parameters, statistics, momentum, EMA and losses as
    four straight steps."""
    model0 = setup[3]
    batches = _pre_crop_batches(4, 6)
    straight, losses = _aug_run(model0, batches)
    first, head = _aug_run(model0, batches[:2])
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(first.step, train_payload(first))
    fresh = copy.deepcopy(model0).float()
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    resumed, tail = _aug_run(fresh, batches, start=2,
                             ckpt=str(tmp_path / "run" / "last"))
    assert head + tail == losses and resumed.step == straight.step == 4
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for part in ("momentum", "ema"):
        for name, t in straight.opt_state[part].items():
            assert torch.equal(t, resumed.opt_state[part][name]), name


def test_checkpoint_manager_keeps_and_links_as_jax(tmp_path):
    """The same saves and metrics: the same step dirs kept, ``last``,
    ``best`` and ``best.json`` (keep=3, ``best`` at the parent; a former
    best that aged out of the window is reaped when ``best`` moves)."""
    model = torch.nn.Linear(2, 2)
    plan = [(1, 5.0), (2, 9.0), (3, 4.0), (4, 3.0), (5, 8.0), (6, 9.5)]
    layouts = []
    for kind in ("ours", "jax"):
        root = tmp_path / kind / "run"
        if kind == "ours":
            mgr = CheckpointManager(str(root), best_root=str(root.parent))
            payload = {"model": model.state_dict(), "opt_state": {}}
        else:
            mgr = jcheckpoint.CheckpointManager(str(root),
                                                best_root=str(root.parent))
            payload = {"params": {"w": np.zeros(2)}}
        # the managers' layout is compared, not the files inside a step dir
        # (the JAX writer's serialisation is the slow part)
        with mock.patch.object(jcheckpoint, "save_checkpoint",
                               lambda path, *_: os.makedirs(path)):
            for step, metric in plan:
                mgr.save(step, {**payload, "step": step}, metric)
        with open(root.parent / "best.json") as f:
            best = json.load(f)
        layouts.append((sorted(d for d in os.listdir(root)
                               if d.startswith("step_")),
                        os.readlink(root / "last"),
                        os.readlink(root.parent / "best"), best))
    assert layouts[0] == layouts[1]
    assert layouts[0][:3] == (["step_00000004", "step_00000005",
                               "step_00000006"], "step_00000006",
                              "run/step_00000006")


def _train_shards(tmp_path):
    rng = np.random.default_rng(0)
    train, val = str(tmp_path / "train"), str(tmp_path / "val")
    write_shards(ArrayDataset(
        rng.integers(0, 256, (5, 256, 256, 3), dtype=np.uint8),
        rng.integers(0, 1000, 5).astype(np.int32)), train, shard_size=2)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (5, 224, 224, 3), dtype=np.uint8),
        rng.integers(0, 1000, 5).astype(np.int32)), val, shard_size=4)
    return train, val


def test_main_train_end_to_end_and_resume(tmp_path, capsys, monkeypatch):
    """``--mode train --device cpu`` on seeded pre-crop shards with the
    recipe's switches (no ``--amp``: bf16 convs are slow on the CPU), one
    epoch of one step (5 images, batch 4, the last dropped); then a resume
    from its ``last`` checkpoint runs the second epoch from step count +
    1."""
    train, val = _train_shards(tmp_path)
    # the logs go to metrics.jsonl alone: TensorBoard's import is slow and
    # not what this test is about
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    base = ["--mode", "train", "--device", "cpu", "--shards_dir", train,
            "--eval_shards_dir", val, "--train_batch_size", "4",
            "--eval_batch_size", "4", "--root_dir", str(tmp_path),
            "--log_interval", "1", "--ema", "0.9", *SMALL]
    first = cli.main(base + ["--max_epochs", "1", "--remat", "--grad_accum",
                             "2", "--label_smooth", "0.1"])
    out = capsys.readouterr().out
    assert "on-device augmentation: RandomResizedCrop(256->224)" in out
    assert "epoch 0 [0/1] loss " in out and "epoch 0 val: top1 " in out
    assert "epoch 0 val[ema]: top1 " in out
    assert first["step"] == 1 and len(first["train"]) == 1
    assert all(np.isfinite(loss) for _, loss, _ in first["train"])
    last = os.path.join(first["ckpt_dir"], "last")
    with open(os.path.join(last, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["model_name"] == "ttnet_imagenet_xsmall"
    assert meta["config"]["remat"] is True
    assert os.path.exists(tmp_path / "ckpt" / "ttnet_imagenet_small" /
                          "best.json")
    second = cli.main(base + ["--max_epochs", "2", "--ckpt", last])
    assert "resumed full train state at step 1" in capsys.readouterr().out
    assert second["start_step"] == 1 and second["step"] == 2
    assert second["train"][0][0] == 2 and np.isfinite(second["train"][0][1])
    # a weights-only .pth starts the optimizer fresh (no epoch is run)
    model = cli.get_model("ttnet_imagenet_xsmall", nfilter=4, tfilter=4,
                          layers=0).init(seed=1, device="cpu")
    torch.save(model.state_dict(), tmp_path / "w.pth")
    third = cli.main(base + ["--max_epochs", "0", "--ckpt",
                             str(tmp_path / "w.pth")])
    assert "starting optimizer fresh" in capsys.readouterr().out
    assert third["start_step"] == third["step"] == 0


def test_main_train_from_image_folder_and_train_shards(tmp_path,
                                                      monkeypatch):
    """``--data_dir``: one step on ``train/`` through the PIL train
    transform, validated on ``val/``; ``--write_shards --shards_split
    train`` stores the 256x256 pre-crop."""
    from PIL import Image

    rng = np.random.default_rng(4)
    for split in ("train", "val"):
        for cls in ("a_cls", "b_cls"):
            d = tmp_path / "data" / split / cls
            d.mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.integers(0, 256, (240 + 9 * i, 260, 3),
                                             dtype=np.uint8)).save(
                    d / f"{i}.png")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    common = ["--device", "cpu", "--data_dir", str(tmp_path / "data"),
              "--num_workers", "2", "--root_dir", str(tmp_path), *SMALL]
    got = cli.main(["--mode", "train", "--train_batch_size", "4",
                    "--eval_batch_size", "4", "--max_epochs", "1", *common])
    assert got["step"] == 1 and len(got["val"]) == 1
    assert np.isfinite(got["val"][0]["loss"])
    meta = cli.main(["--write_shards", str(tmp_path / "sh"),
                     "--shards_split", "train", *common])
    assert meta["n"] == 6 and tuple(meta["shape"]) == (256, 256, 3)


@pytest.mark.parametrize("argv,match", [
    (["--lut"], "--lut is a serving mode"),
    (["--bf16"], "bf16 mixed-precision training is --amp"),
    (["--fold_bn"], "training needs live BN"),
    (["--sp"], "spatially-partitioned EVAL"),
    (["--native_data"], "pre-decode once with --write_shards"),
    (["--gates", "dnf"], "serve its boolean circuit"),
    (["--certify", "0.1"], "certified EVAL"),
    (["--attack", "fgsm"], "adversarial EVAL"),
    (["--stability_eps", "0.1", "--amp"],
     "--amp is not supported with robust"),
    # --tp is ported (tests/test_torch_tp*.py), in f32 only, as in JAX
    (["--tp", "--amp"], "channel-sharded amp is not implemented"),
    (["--grad_accum", "3"], "must be divisible by grad_accum"),
    (["--ema", "1.5"], "decay must be in"),
    ([], "0 train steps per epoch")])
def test_train_refuses_flags_it_does_not_carry(tmp_path, argv, match):
    train, _ = _train_shards(tmp_path)
    batch = "16" if not argv else "4"
    with pytest.raises(ValueError, match=match):
        cli.main(["--mode", "train", "--device", "cpu", "--shards_dir",
                  train, "--train_batch_size", batch, "--root_dir",
                  str(tmp_path), *SMALL, *argv])


@pytest.mark.parametrize("mode", ["serve", "eval"])
def test_train_flags_refused_outside_training(mode):
    with pytest.raises(ValueError, match="does not apply" if mode == "serve"
                       else "TRAIN loss"):
        cli.main(["--mode", mode, "--device", "cpu", "--shards_dir", "d",
                  "--label_smooth", "0.1", *SMALL])
