"""Multi-process ``main`` on the CPU (gloo, two ranks, each a real
process through ``tests/_torch_main_rank.py``; one launch for the file,
whose ranks run the three jobs below in turn), against the one-process
run of the same flags.

* ``--mode eval --shards_dir`` as conv (ranks joined by ``--num_processes
  --process_id --coordinator_address``): top-1 and top-5 equal the
  one-process run's, the loss within 1e-4 (each rank's batch is half as
  large, so f32 sums round apart), and every image scored exactly once
  (uneven shards: one rank pads its tail and runs a filler batch).
* ``--lut --lut_path`` through torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``; no
  flag): rank 0 alone compiles into the archive and writes it, and the
  one-process run that loads it scores the same.
* ``--mode train`` of two steps: the ranks' final parameters and
  statistics are bit-equal, only rank 0 writes logs and checkpoints, and
  the per-epoch validation runs over both ranks (it equals a one-process
  eval of the trained weights).
* The refusals, in-process: the JAX CLI's texts (its serve, export and
  ``--gates`` refusals of ``--num_processes``, its mesh and 0-step
  messages) and the port's own rules (``--platform``/``--cpu_devices``,
  one-process modes, a rendezvous flag without a world); ``--sp`` refuses
  a model axis of 1 with the JAX CLI's text, and ``--mesh_model``/``--tp``
  (their runs, and ``--sp``'s, are ``tests/test_torch_tp_cli.py``'s and
  ``tests/test_torch_sp_cli.py``'s) refuse a world they cannot split and
  ``--gates``.
"""

import io
import json
import os
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

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

SMALL = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter",
         "4", "--layers", "0", "--model_arg", "image_size=64"]
RUNNER = "tests/_torch_main_rank.py"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """21 eval images in shards of 5 (rank 0 reads 11, rank 1 10) and 8
    train images in shards of 4, 64x64."""
    root = tmp_path_factory.mktemp("dist_cli")
    rng = np.random.default_rng(31)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (21, 64, 64, 3), dtype=np.uint8),
        rng.integers(0, 1000, 21).astype(np.int32)), str(root / "val"),
        shard_size=5)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
        rng.integers(0, 1000, 8).astype(np.int32)), str(root / "train"),
        shard_size=4)
    return root


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out
    return json.loads(line[0][len("RESULT "):])


def _flags(address, r):
    return ["--num_processes", "2", "--process_id", str(r),
            "--coordinator_address", address]


def _eval_argv(data, root):
    return ["--mode", "eval", "--shards_dir", str(data / "val"),
            "--eval_batch_size", "4", "--root_dir", str(root), "--seed",
            "3", *SMALL]


def _lut_argv(data, root):
    return ["--mode", "eval", "--shards_dir", str(data / "val"),
            "--eval_batch_size", "4", "--root_dir", str(root), *SMALL,
            "--lut", "--lut_path", str(root / "luts.npz")]


def _train_argv(data, root):
    return ["--mode", "train", "--shards_dir", str(data / "train"),
            "--eval_shards_dir", str(data / "val"), "--train_batch_size",
            "4", "--eval_batch_size", "4", "--max_epochs", "1",
            "--log_interval", "1", "--lr", "0.05", "--root_dir",
            str(root / "run"), *SMALL]


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """One launch of two rank processes for the whole file, each running
    three jobs in turn, each its own process group: the conv eval joined
    by the flags, the ``--lut`` eval by torchrun's environment, and two
    training steps by the flags.  Each job's outputs by rank, and its
    directory."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("conv", "lut",
                                                    "train")}
    ports = [free_port() for _ in dirs]
    jobs = []
    for r in range(2):
        jobs.append(tmp_path_factory.getbasetemp() / f"jobs{r}.json")
        jobs[r].write_text(json.dumps([
            {"argv": _eval_argv(data, dirs["conv"]) + ["--device", "cpu"]
             + _flags(f"localhost:{ports[0]}", r)},
            {"argv": _lut_argv(data, dirs["lut"]) + ["--device", "cpu"],
             "env": {"RANK": str(r), "LOCAL_RANK": str(r),
                     "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                     "MASTER_PORT": str(ports[1])}},
            {"argv": _train_argv(data, dirs["train"]) + ["--device", "cpu"]
             + _flags(f"localhost:{ports[2]}", r),
             "save_model": str(dirs["train"] / f"rank{r}.pth")}]))
    outs = launch_ranks(lambda r: [RUNNER, str(jobs[r])])
    split = [o.split("JOB ")[1:] for o in outs]
    return {k: ([split[r][i] for r in range(2)], d)
            for i, (k, d) in enumerate(dirs.items())}


def _one_process(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        res = cli.main(argv + ["--device", "cpu"])
    return res, out.getvalue()


def _same_metrics(two, one):
    assert two[:2] == pytest.approx(one[:2], abs=1e-9)
    assert abs(two[2] - one[2]) < 1e-4


def test_two_process_eval_scores_every_image_once(data, ranks, tmp_path):
    outs, root = ranks["conv"]
    one, one_out = _one_process(_eval_argv(data, tmp_path))
    two = [_result(o) for o in outs]
    assert two[0] == two[1]                   # every rank the global sums
    _same_metrics(two[0], one)
    assert "scored 21 images over 2 ranks" in outs[0]
    assert "scored 21 images" in one_out
    assert "final:" in outs[0] and "final:" not in outs[1]
    assert "mesh: {'data': 2, 'model': 1} over 2 devices / 2 processes " \
           "(gloo)" in outs[0]
    # the eval logs are rank 0's alone: one run dir
    assert len(os.listdir(root / "logs" / "ttnet_imagenet_small")) == 1


def test_two_process_lut_eval_through_torchrun_env(data, ranks):
    outs, root = ranks["lut"]
    assert "saved LUTs" in outs[0] and "saved LUTs" not in outs[1]
    assert os.path.exists(root / "luts.npz")
    one, one_out = _one_process(_lut_argv(data, root))
    assert "loading LUTs" in one_out
    two = _result(outs[0])
    assert two == _result(outs[1])
    _same_metrics(two, one)
    assert "scored 21 images over 2 ranks" in outs[0]


def test_two_process_train_keeps_ranks_equal(data, ranks, tmp_path):
    outs, root = ranks["train"]
    res = [_result(o) for o in outs]
    assert res[0]["step"] == res[1]["step"] == 2
    assert res[0]["train"] == res[1]["train"] and len(res[0]["train"]) == 2
    assert res[0]["val"] == res[1]["val"] and len(res[0]["val"]) == 1
    s0, s1 = (torch.load(root / f"rank{r}.pth") for r in range(2))
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    start = cli.get_model("ttnet_imagenet_xsmall", nfilter=4, tfilter=4,
                          layers=0, image_size=64).init(seed=0, device="cpu")
    assert not torch.equal(s0["features.1.weight"],
                           start.state_dict()["features.1.weight"])
    # rank 0 alone logs and writes: one run dir each, one checkpoint
    logs = root / "run" / "logs" / "ttnet_imagenet_small"
    ckpts = root / "run" / "ckpt" / "ttnet_imagenet_small"
    assert len(os.listdir(logs)) == 1
    runs = [d for d in os.listdir(ckpts) if d not in ("best", "best.json")]
    assert len(runs) == 1
    assert sorted(os.listdir(ckpts / runs[0])) == ["last", "step_00000002"]
    assert "epoch 0 [0/2]" in outs[0] and "epoch 0 [" not in outs[1]
    # the validation scored the whole val set over both ranks
    val = res[0]["val"][0]
    torch.save(s0, tmp_path / "trained.pth")
    one, _ = _one_process(["--mode", "eval", "--shards_dir",
                           str(data / "val"), "--eval_batch_size", "4",
                           "--ckpt", str(tmp_path / "trained.pth"),
                           "--root_dir", str(tmp_path), *SMALL])
    _same_metrics((val["top1"], val["top5"], val["loss"]), one)


# ------------------------------------------------------------ refusals

# the JAX CLI's texts where it refuses a world above one
# (``scale_imagenet_tpu/main.py:765,879,1003-1005``): it raises them after
# its rendezvous, which one test process cannot make
JAX_WORLD = {
    "serve": "--mode serve is single-host inference serving; "
             "--num_processes does not apply",
    "export": "--mode export writes the UNMODIFIED weights in the "
              "reference layout; --num_processes does not apply",
    "eval": "--gates is a single-host verification runtime; drop "
            "--num_processes",
}


@pytest.mark.parametrize("mode", list(JAX_WORLD))
def test_world_refusals_carry_the_jax_text(mode):
    extra = ["--gates", "dnf", "--shards_dir", "d"] if mode == "eval" else []
    with pytest.raises(ValueError) as err:
        cli.main(["--mode", mode, "--num_processes", "2", "--process_id",
                  "0", "--coordinator_address", "localhost:1", *extra,
                  *SMALL, "--device", "cpu"])
    assert str(err.value) == JAX_WORLD[mode]


def _zero_params(cfg, model):
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        jax.eval_shape(model.init, jax.random.PRNGKey(0)))


class _NoLogger:
    def __init__(self, *a, **k):
        pass

    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _jax_error(argv):
    with mock.patch.object(jmain, "load_params", _zero_params), \
            mock.patch.object(jtrain, "MetricsLogger", _NoLogger), \
            pytest.raises(Exception) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv)
    return err.value


@pytest.mark.parametrize("argv", [
    ["--mode", "eval", "--mesh_data", "3", "--eval_batch_size", "4"],
    ["--mode", "train", "--train_batch_size", "16"],
], ids=["mesh", "zero_steps"])
def test_mesh_and_zero_step_messages_match_jax(data, tmp_path, argv):
    """The mesh larger than the devices (one here: JAX is given one CPU
    device), and the 0-step message with its rank, world and the shard
    hint."""
    shards = "val" if argv[1] == "eval" else "train"
    full = argv + ["--shards_dir", str(data / shards), "--root_dir",
                   str(tmp_path), *SMALL]
    with mock.patch.object(jax, "devices", lambda *a: jax.local_devices()[:1]):
        want = _jax_error(full)
    with pytest.raises(type(want)) as got, redirect_stdout(io.StringIO()):
        cli.main(full + ["--device", "cpu"])
    assert str(got.value) == str(want)


@pytest.mark.parametrize("argv,match", [
    (["--platform", "cpu"], "--platform/--cpu_devices pick the JAX "
                            "package's platform"),
    (["--cpu_devices", "8"], "pick the device with --device .cuda or cpu. "
                             "and the ranks with --num_processes"),
    (["--mode", "compile", "--num_processes", "2"],
     "--mode compile runs in one process on one device; --num_processes "
     "does not apply"),
    (["--mode", "export", "--mesh_data", "2"],
     "--mode export runs in one process on one device; --mesh_data does "
     "not apply"),
    (["--write_shards", "w", "--data_dir", "d", "--num_processes", "2"],
     "--write_shards runs in one process on one device"),
    (["--mode", "eval", "--shards_dir", "d", "--process_id", "1"],
     "join a run of several processes; give --num_processes N > 1"),
    (["--mode", "serve", "--mesh_data", "2"],
     "mesh 2x1 needs more than the 1 available devices"),
    (["--mode", "eval", "--shards_dir", "d", "--mesh_model", "2"],
     "1 devices not divisible by model=2"),
    (["--mode", "eval", "--shards_dir", "d", "--tp", "--gates", "dnf"],
     "--gates is the HOST circuit runtime; mesh-sharded compiled serving "
     "is --tp --lut"),
    (["--mode", "eval", "--shards_dir", "d", "--sp"],
     "--sp shards image height over the 'model' axis; run with "
     "--mesh_model>1")],
    ids=["platform", "cpu_devices", "compile", "export_mesh",
         "write_shards", "join_alone", "serve_mesh", "mesh_model", "tp",
         "sp"])
def test_port_rules(argv, match):
    with pytest.raises(ValueError, match=match):
        cli.main(argv + SMALL + ["--device", "cpu"])


def test_a_world_without_its_rendezvous_names_the_missing_flags(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--num_processes 2 needs "
                                         "--process_id and "
                                         "--coordinator_address"):
        cli.main(["--mode", "eval", "--shards_dir", "d", "--num_processes",
                  "2", *SMALL, "--device", "cpu"])
