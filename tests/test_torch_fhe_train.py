"""Training of the TT_FHE family and its 32x32 data route against the JAX
package on the CPU.

Two consecutive f64 train steps (momentum, weight decay and an LR
milestone between them) of ``TT_FHE_SMALL``, ``TT_FHE_SMALL_bireal`` and
the noisy ``TT_FHE_small`` at nfilter = tfilter = 4, B = 4, from one JAX
init and the same seeded batches, give the same loss, top-1/5, parameters
and BN running statistics to 1e-9 relative, as ``make_train_step`` does.
``TT_FHE_small``'s coin flips are recorded in JAX's compiled step (an
ordered debug callback) and replayed into the port's step
(``_torch_port.Replay``).  The CIFAR transforms match JAX's to 1e-6 from
the same ``random.Random`` seed, and ``main --mode train`` and ``--mode
eval`` run from a 32x32 ImageFolder and from 32x32 shards.
"""

import io
import os
import random
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from _torch_port import Replay, jax_and_port, jax_train_steps, \
    recorded_bernoulli, x64  # noqa: F401
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu.data import transforms as jtf
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.data import transforms as ttf
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

OPT = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
W = ["--nfilter", "2", "--tfilter", "2"]


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _assert_trees_close(got, want):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["TT_FHE_SMALL", "TT_FHE_SMALL_bireal",
                                  "TT_FHE_small"])
def test_two_train_steps_match_jax(x64, name):  # noqa: F811
    jm, params, state, md, model = jax_and_port(name, np.float64, seed=7,
                                                jit=True, nfilter=4,
                                                tfilter=4)
    rng = np.random.default_rng(8)
    batches = [(rng.uniform(-1, 1, (4, 32, 32, 3)),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(2)]
    tx, _ = jmake_optimizer(**OPT)
    keys = [jax.random.PRNGKey(i) for i in range(2)] if md.stochastic \
        else None
    with recorded_bernoulli() as flips:
        jparams, jstate, jmetrics, _ = jax_train_steps(
            jm, tx, params, state, batches, keys=keys)
    # the stem, heads 1-3 and the fuse head draw once a step
    assert len(flips) == (10 if md.stochastic else 0)
    draws = [flips[:5], flips[5:]]
    opt, _ = make_optimizer(**OPT)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for (x, y), want, d in zip(batches, jmetrics, draws):
        noise = Replay(d) if md.stochastic else None
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y),
                     noise=noise)
        assert noise is None or noise.used == len(d)
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-9, atol=1e-9,
                                       err_msg=k)
    got_p, got_s = jax_trees(ts.model)
    _assert_trees_close(got_p, jparams)
    _assert_trees_close(got_s, jstate)
    if name == "TT_FHE_SMALL_bireal":
        # the Bi-Real stem's alpha and beta train
        assert float(got_p["stem_act"]["alpha"]) != 1.0
        assert float(got_p["stem_act"]["beta"]) != 0.0


def _pil_images(n: int, seed: int, size: int = 32):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                         dtype=np.uint8)) for _ in range(n)]


def test_cifar_transforms_match_jax():
    np.testing.assert_array_equal(ttf.CIFAR_MEAN, jtf.CIFAR_MEAN)
    np.testing.assert_array_equal(ttf.CIFAR_STD, jtf.CIFAR_STD)
    for i, img in enumerate(_pil_images(6, 1)):
        np.testing.assert_allclose(ttf.cifar_eval_transform(img),
                                   jtf.cifar_eval_transform(img),
                                   rtol=1e-6, atol=1e-6)
        got = ttf.cifar_train_transform(img, rng=random.Random(i))
        want = jtf.cifar_train_transform(img, rng=random.Random(i))
        assert got.shape == (32, 32, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the train transform normalizes with the ImageNet statistics, as the
    # reference does; eval with the CIFAR ones
    img = _pil_images(1, 2)[0]
    flat = np.asarray(img, np.float32) / 255.0
    np.testing.assert_allclose(
        ttf.cifar_eval_transform(img),
        (flat - ttf.CIFAR_MEAN) / ttf.CIFAR_STD, rtol=1e-6)
    assert cli._pick_transforms(32) == (ttf.cifar_eval_transform,
                                        ttf.cifar_train_transform)
    assert cli._pick_transforms(224)[0] is ttf.imagenet_eval_transform


def _image_folder(root: str) -> str:
    for split, n in (("train", 4), ("val", 2)):
        for c in range(2):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i, img in enumerate(_pil_images(n, 10 * c + n)):
                img.save(os.path.join(d, f"{i}.png"))
    return root


def test_main_train_and_eval_from_a_32px_image_folder(tmp_path):
    """``--data_dir`` of a 32x32 model: training through the CIFAR train
    transform with per-epoch validation, then ``--mode eval``."""
    root = _image_folder(str(tmp_path / "data"))
    base = ["--model", "TT_FHE_SMALL", *W, "--device", "cpu", "--data_dir",
            root, "--train_batch_size", "2", "--eval_batch_size", "2",
            "--num_workers", "1", "--root_dir", str(tmp_path / "run")]
    with redirect_stdout(io.StringIO()):
        summary = cli.main(["--mode", "train", "--max_epochs", "1",
                            "--log_interval", "1", *base])
    assert summary["step"] == 4 and len(summary["val"]) == 1
    assert all(np.isfinite(loss) for _, loss, _ in summary["train"])
    with redirect_stdout(io.StringIO()) as out:
        top1, top5, loss = cli.main(["--mode", "eval", *base, "--ckpt",
                                     f"{summary['ckpt_dir']}/last"])
    assert "eval dataset: 4 images / 2 classes" in out.getvalue()
    assert 0 <= top1 <= top5 <= 100 and np.isfinite(loss)


def _shards(tmp_path, n_train=4, n_val=6):
    rng = np.random.default_rng(4)
    paths = []
    for split, n in (("train", n_train), ("val", n_val)):
        write_shards(ArrayDataset(
            rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32)),
            str(tmp_path / split))
        paths.append(str(tmp_path / split))
    return paths


def test_main_train_and_eval_tt_fhe_small_from_shards(tmp_path):
    """``TT_FHE_small`` trains from 32x32 shards (the flip on the device)
    and its eval repeats from ``--seed``: the same seed the same metrics,
    fresh coin flips every batch."""
    train, val = _shards(tmp_path)
    base = ["--model", "TT_FHE_small", *W, "--device", "cpu",
            "--eval_batch_size", "2", "--root_dir", str(tmp_path / "run")]
    with redirect_stdout(io.StringIO()):
        summary = cli.main(["--mode", "train", *base, "--shards_dir", train,
                            "--eval_shards_dir", val, "--train_batch_size",
                            "2", "--max_epochs", "1"])
    assert summary["step"] == 2 and len(summary["val"]) == 1
    ckpt = ["--ckpt", f"{summary['ckpt_dir']}/last"]
    runs = {}
    for seed in ("3", "3", "4"):
        with redirect_stdout(io.StringIO()):
            runs.setdefault(seed, []).append(cli.main(
                ["--mode", "eval", *base, *ckpt, "--shards_dir", val,
                 "--seed", seed]))
    assert runs["3"][0] == runs["3"][1]
    assert all(np.isfinite(v) for v in runs["4"][0])


def test_main_train_valexnet_from_shards(tmp_path):
    """``TT_FHE_XSMALL_vAlexnet`` (fixed p = 64) trains one epoch."""
    train, _ = _shards(tmp_path, n_train=2)
    with redirect_stdout(io.StringIO()):
        summary = cli.main(["--mode", "train", "--model",
                            "TT_FHE_XSMALL_vAlexnet", "--device", "cpu",
                            "--shards_dir", train, "--train_batch_size", "2",
                            "--max_epochs", "1", "--log_interval", "1",
                            "--root_dir", str(tmp_path / "run")])
    assert summary["step"] == 1
    assert np.isfinite(summary["train"][0][1])
