"""Tensor parallelism through ``python -m scale_imagenet_tpu_torch.main``
on the CPU: one launch of four gloo ranks on a 2x2 (data, model) mesh
(``tests/_torch_main_rank.py``, each rank running the file's ``main``
jobs in turn, as ``tests/test_torch_dist_cli.py`` runs its three), at
``tests/test_multiproc_cli.py``'s width (p = 32, ``--layers 0``, a
16-class head) on 64x64 images:

* ``--tp`` eval scores every image once, its metrics within 1e-3 of the
  one-process run;
* ``--mesh_model 2`` training without ``--tp`` (the model axis's ranks
  replicated), then ``--tp`` training from the same weights: the first
  ``--tp`` loss within 1e-3 relative of the replicated run's (the same
  rows and augmentation on a data index, the same math up to the
  classifier sum's order), and after both steps the gathered weights and
  BN statistics equal the replicated run's up to 1e-3 of the update (so
  the data axis takes the mean, over the data group alone); rank 0 alone
  writes ``step_*``; the gathered checkpoint loads strict in one process
  and scores there what the TP validation scored;
* ``--tp`` training resumes the replicated run's checkpoint (written by
  one rank, whole): its full train state at step 2;
* the refusals, in-process: the JAX CLI's texts for ``--tp`` in serve,
  compile and export, with ``--amp``/``--remat``/robust training/
  ``--label_smooth``/``--gates``/``--certify``, on the VGG stem and
  TT_FHE; ``--sp`` on a family outside the port's row-sharded forward
  names ``ROADMAP.md``.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads, free_port, launch_ranks  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu import train as jtrain
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards

pytestmark = pytest.mark.usefixtures("few_threads")

P32 = ["--model", "ttnet_imagenet_small", "--nfilter", "8", "--tfilter",
       "4", "--layers", "0", "--model_arg", "image_size=64", "--model_arg",
       "num_classes=16"]
RUNNER = "tests/_torch_main_rank.py"
WORLD = 4
MESH = ["--mesh_model", "2"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """21 eval images in shards of 5 (data index 0 reads 11, 1 reads 10)
    and 8 train pre-crops (72 -> 64) in shards of 2: two steps of B = 4
    (2 a data index)."""
    root = tmp_path_factory.mktemp("tp_cli")
    rng = np.random.default_rng(61)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (21, 64, 64, 3), dtype=np.uint8),
        rng.integers(0, 16, 21).astype(np.int32)), str(root / "val"),
        shard_size=5)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (8, 72, 72, 3), dtype=np.uint8),
        rng.integers(0, 16, 8).astype(np.int32)), str(root / "train"),
        shard_size=2)
    return root


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out
    return json.loads(line[0][len("RESULT "):])


def _eval_argv(data, root):
    return ["--mode", "eval", "--shards_dir", str(data / "val"),
            "--eval_batch_size", "4", "--root_dir", str(root), *P32]


def _train_argv(data, root):
    return ["--mode", "train", "--shards_dir", str(data / "train"),
            "--eval_shards_dir", str(data / "val"), "--train_batch_size",
            "4", "--eval_batch_size", "4", "--max_epochs", "1",
            "--log_interval", "1", "--lr", "0.05", "--seed", "5",
            "--root_dir", str(root), *P32]


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """One launch of four ranks, each running four jobs in turn, each its
    own process group: ``--tp`` eval, replicated training, ``--tp``
    training, and ``--tp`` training resumed from the replicated run's
    checkpoint.  Each job's outputs by rank, and its directory."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("eval", "replicated",
                                                    "tp", "resume")}
    ports = [free_port() for _ in dirs]
    jobs = []
    for r in range(WORLD):
        def flags(i):
            return ["--device", "cpu", *MESH, "--num_processes", str(WORLD),
                    "--process_id", str(r), "--coordinator_address",
                    f"localhost:{ports[i]}"]
        jobs.append(tmp_path_factory.getbasetemp() / f"tp_jobs{r}.json")
        resume = _train_argv(data, dirs["resume"]) + ["--tp", "--max_epochs",
                                                      "2"]
        jobs[r].write_text(json.dumps([
            {"argv": _eval_argv(data, dirs["eval"]) + ["--tp"] + flags(0)},
            {"argv": _train_argv(data, dirs["replicated"]) + flags(1)},
            {"argv": _train_argv(data, dirs["tp"]) + ["--tp"] + flags(2),
             "save_model": str(dirs["tp"] / f"rank{r}.pth")},
            {"argv": resume + flags(3), "resume_under": str(
                dirs["replicated"] / "ckpt" / "ttnet_imagenet_small")}]))
    outs = launch_ranks(lambda r: [RUNNER, str(jobs[r])], world=WORLD)
    split = [o.split("JOB ")[1:] for o in outs]
    return {k: ([split[r][i] for r in range(WORLD)], d)
            for i, (k, d) in enumerate(dirs.items())}


def _one_process(argv):
    """``main`` in this process, its metrics logged to ``metrics.jsonl``
    alone (TensorBoard's first import takes seconds)."""
    out = io.StringIO()
    with redirect_stdout(out), \
            mock.patch.dict(sys.modules, {"torch.utils.tensorboard": None}):
        res = cli.main(argv + ["--device", "cpu"])
    return res, out.getvalue()


def _close(two, one, tol=1e-3):
    assert two[:2] == pytest.approx(one[:2], abs=tol)
    assert two[2] == pytest.approx(one[2], rel=tol)


def test_tp_eval_matches_one_process(data, ranks, tmp_path):
    outs, _ = ranks["eval"]
    res = [_result(o) for o in outs]
    assert all(r == res[0] for r in res)
    one, _ = _one_process(_eval_argv(data, tmp_path))
    _close(res[0], one)
    assert "mesh: {'data': 2, 'model': 2} over 4 devices / 4 processes " \
           "(gloo)" in outs[0]
    assert "scored 21 images over 4 ranks" in outs[0]
    assert all("final:" not in o for o in outs[1:])


def _runs(root):
    ckpts = root / "ckpt" / "ttnet_imagenet_small"
    return [d for d in os.listdir(ckpts) if d not in ("best", "best.json")]


def test_tp_train_matches_replicated_and_checkpoints_whole(data, ranks,
                                                           tmp_path):
    (rep, _), (tp, root) = ranks["replicated"], ranks["tp"]
    rep_res = [_result(o) for o in rep]
    tp_res = [_result(o) for o in tp]
    assert all(r["train"] == rep_res[0]["train"] for r in rep_res)
    assert all(r["train"] == tp_res[0]["train"] for r in tp_res)
    assert tp_res[0]["step"] == rep_res[0]["step"] == 2
    # the first step from the same weights on the same rows
    assert tp_res[0]["train"][0][1] == pytest.approx(
        rep_res[0]["train"][0][1], rel=1e-3)
    assert "epoch 0 [0/2]" in tp[0] and all("epoch 0 [" not in o
                                            for o in tp[1:])
    # the model ranks hold halves of the channels, the same head
    locals_ = [torch.load(root / f"rank{r}.pth") for r in range(WORLD)]
    stem = "features.1.weight"
    assert locals_[0][stem].shape[0] == 16
    for k in ("features.8.lin2.weight", "features.8.BN2.running_mean"):
        assert all(torch.equal(s[k], locals_[0][k]) for s in locals_), k
    # rank 0 alone writes: one run dir, its step
    runs = _runs(root)
    assert len(runs) == 1
    ckpt = root / "ckpt" / "ttnet_imagenet_small" / runs[0]
    assert sorted(os.listdir(ckpt)) == ["last", "step_00000002"]
    # the gathered checkpoint loads strict in one process and scores what
    # the TP validation scored
    whole = torch.load(ckpt / "last" / "model.pth")
    assert torch.equal(whole[stem][:16], locals_[0][stem])
    assert torch.equal(whole[stem][16:], locals_[1][stem])
    one, out = _one_process(_eval_argv(data, tmp_path) + [
        "--ckpt", str(ckpt / "last")])
    val = tp_res[0]["val"][0]
    _close((val["top1"], val["top5"], val["loss"]), one)
    # two steps over data = 2: the TP run's gathered weights and BN
    # statistics moved as the replicated run's did, up to the f32 order of
    # the classifier's sum (2.3e-5 of the update's norm here); a gradient
    # summed over data, or averaged over the world and so mixing channel
    # slices, misses by a large share of the update
    rep_root = ranks["replicated"][1]
    rep = torch.load(rep_root / "ckpt" / "ttnet_imagenet_small"
                     / _runs(rep_root)[0] / "last" / "model.pth")
    start = cli.get_model("ttnet_imagenet_small", nfilter=8, tfilter=4,
                          layers=0, image_size=64, num_classes=16).init(
        seed=5, device="cpu").state_dict()
    assert whole.keys() == rep.keys() == start.keys()
    floats = [k for k, v in start.items() if v.is_floating_point()]
    du = torch.cat([(whole[k] - start[k]).double().ravel() for k in floats])
    dv = torch.cat([(rep[k] - start[k]).double().ravel() for k in floats])
    gap = float((du - dv).norm() / dv.norm())
    assert gap <= 1e-3, gap


def test_tp_resumes_a_whole_checkpoint(ranks):
    outs, _ = ranks["resume"]
    assert "resumed full train state at step 2" in outs[0]
    res = [_result(o) for o in outs]
    assert res[0]["start_step"] == 2 and res[0]["step"] == 4
    assert all(r["train"] == res[0]["train"] for r in res)


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
        jmain.main(argv + ["--mesh_data", "1"])
    return err.value


XS = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter", "4",
      "--layers", "0"]
REFUSED = [
    ("serve", XS, []),
    ("compile", XS, []),
    ("export", XS, []),
    ("train", XS, ["--amp"]),
    ("train", XS, ["--remat"]),
    ("train", XS, ["--stability_eps", "0.1"]),
    ("train", XS, ["--label_smooth", "0.1"]),
    ("train", ["--model", "ttnet_imagenet_vgg_stem"], []),
    ("eval", XS, ["--gates", "dnf"]),
    ("eval", XS, ["--certify", "0.1"]),
    ("eval", XS, ["--attack", "fgsm", "--attack_eps", "0.1"]),
    ("eval", ["--model", "TT_FHE_SMALL", "--nfilter", "4", "--tfilter", "4"],
     ["--lut"]),
    ("eval", ["--model", "ttnet_imagenet_vgg_stem"], []),
]


@pytest.fixture(scope="module")
def shards224(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_refusals") / "shards"
    rng = np.random.default_rng(67)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8),
        rng.integers(0, 10, 2).astype(np.int32)), str(path))
    return str(path)


@pytest.mark.parametrize("mode,model,argv", REFUSED, ids=[
    f"{m}-{md[1]}-{'_'.join(a)}" for m, md, a in REFUSED])
def test_tp_refusals_are_the_jax_messages(shards224, tmp_path, mode, model,
                                          argv):
    base = ["--mode", mode, *model, "--tp", "--root_dir", str(tmp_path),
            *argv]
    if mode in ("train", "eval"):
        base += ["--shards_dir", shards224, "--train_batch_size", "2",
                 "--eval_batch_size", "2"]
    want = _jax_error(base)
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(base + ["--device", "cpu"])
    if isinstance(want, AttributeError):
        # the VGG stem's eval: JAX's local_config crashes; the port names it
        assert f"(AttributeError: {want})" in str(got.value)
    else:
        assert isinstance(want, ValueError) and str(got.value) == str(want)


def test_sp_names_the_roadmap():
    with pytest.raises(ValueError, match="covers the ttnet_imagenet family "
                                         "so far, not TTnetVGGStemConfig.*"
                                         "ROADMAP.md"):
        cli.main(["--mode", "eval", "--shards_dir", "d", "--sp",
                  "--mesh_model", "2", "--model", "ttnet_imagenet_vgg_stem",
                  "--device", "cpu"])
