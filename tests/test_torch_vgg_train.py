"""``--mode train`` of the port's VGG16-stem TTnet
(``TT_vf_19lv3_imgnet_xsmall_VGG``) against the JAX package on the CPU, at
its full width (p = 64, 224x224 inputs) and B = 2: one JAX init feeds both
sides through ``convert/from_jax.py``.

Two consecutive f64 steps (momentum and weight decay act, and an LR
milestone falls between them) from the same seeded numpy batches of
patch images (``_structured`` says why not pixel noise) give the
same loss, top-1/5, parameters and BN running statistics to 1e-9 relative:
the batch statistics go through the stem BN, the block and the classifier,
and every parameter (the stem's convs too) is updated, as in JAX's
``make_train_step``.  Then ``main --mode train`` runs from 256x256
pre-crop shards with the full on-device augmentation.
"""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_and_port, jax_train_steps

from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

NAME = "ttnet_imagenet_vgg_stem"
OPT = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _structured(seed: int) -> np.ndarray:
    """Two 224^2 zero-mean images of 16x16 constant patches in [-1, 1], as
    normalized images are.  Pixel noise in [0, 1) averages to a
    near-constant positive field under the stem's AvgPool(4), which leaves
    stem channels dead (ReLU 0) on the whole batch; such a channel
    is a constant input of the block's training BNs, so its BN bias gets a
    gradient of 0 up to rounding, and the sign of the rounding then sets
    its bits and every running statistic behind them (a tie, not a fault:
    the loss does not depend on it)."""
    low = np.random.default_rng(seed).uniform(-1, 1, size=(2, 14, 14, 3))
    return np.repeat(np.repeat(low, 16, axis=1), 16, axis=2)


def _dead_stem_channels(model, x) -> int:
    from scale_imagenet_tpu_torch.layers.conv import conv2d
    from scale_imagenet_tpu_torch.layers.pool import avg_pool
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw

    with torch.no_grad():
        h = avg_pool(_nchw(torch.from_numpy(x), model), 4)
        for conv in (model.stem_conv, model.stem_conv2):
            h = torch.relu(conv2d(h, conv.weight, conv.bias, padding=1))
    return int((h == 0).all(dim=(0, 2, 3)).sum())


def test_two_train_steps_match_jax(x64_module):
    jm, params, state, md, model = jax_and_port(NAME, np.float64, seed=6,
                                                jit=True)
    rng = np.random.default_rng(3)
    batches = [(_structured(s), rng.integers(0, 1000, 2).astype(np.int32))
               for s in (4, 5)]
    assert not any(_dead_stem_channels(model, x) for x, _ in batches)
    tx, _ = jmake_optimizer(**OPT)
    jparams, jstate, jmetrics, _ = jax_train_steps(jm, tx, params, state,
                                                   batches)
    opt, _ = make_optimizer(**OPT)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for (x, y), want in zip(batches, jmetrics):
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y))
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-9, atol=1e-9,
                                       err_msg=k)
    got_p, got_s = jax_trees(ts.model)
    for got, want in ((got_p, jparams), (got_s, jstate)):
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat) == len(jax.tree.leaves(got))
        for path, w in flat:
            g = got
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                       err_msg=jax.tree_util.keystr(path))
    # the stem's convs and BN moved, as every parameter does in JAX
    p0 = jax.tree.map(np.asarray, params)
    for name in ("vgg_conv1", "vgg_conv2", "stem_bn"):
        assert not np.array_equal(got_p[name]["weight"], p0[name]["weight"])
    assert not np.array_equal(got_s["stem_bn"]["running_mean"],
                              state["stem_bn"]["running_mean"])


def test_main_train_from_precrop_shards(tmp_path):
    """``main --mode train`` of the VGG stem: 256^2 pre-crop shards (the
    full augmentation on the device), one epoch of two steps, validation
    on 224^2 shards, a checkpoint that ``--ckpt`` resumes at step 2."""
    rng = np.random.default_rng(9)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8),
        rng.integers(0, 10, 4).astype(np.int32)), str(tmp_path / "train"))
    write_shards(ArrayDataset(
        rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8),
        rng.integers(0, 10, 2).astype(np.int32)), str(tmp_path / "val"))
    argv = ["--mode", "train", "--device", "cpu", "--model", NAME,
            "--shards_dir", str(tmp_path / "train"), "--eval_shards_dir",
            str(tmp_path / "val"), "--train_batch_size", "2",
            "--eval_batch_size", "2", "--root_dir", str(tmp_path),
            "--log_interval", "1"]
    with redirect_stdout(io.StringIO()) as out:
        summary = cli.main(argv + ["--max_epochs", "1"])
    assert "RandomResizedCrop(256->224)" in out.getvalue()
    assert summary["step"] == 2 and len(summary["val"]) == 1
    assert all(np.isfinite(loss) for _, loss, _ in summary["train"])
    with redirect_stdout(io.StringIO()) as out:
        again = cli.main(argv + ["--max_epochs", "2", "--ckpt",
                                 f"{summary['ckpt_dir']}/last"])
    assert "resumed full train state at step 2" in out.getvalue()
    assert again["start_step"] == 2 and again["step"] == 4
    model = get_model(NAME).init(device="cpu")
    cli.load_checkpoint(model, f"{again['ckpt_dir']}/last")
