"""Spatial partitioning through ``python -m scale_imagenet_tpu_torch.main``
on the CPU: one launch of four gloo ranks (``tests/_torch_main_rank.py``,
each running the file's ``main`` jobs in turn, each its own process
group), on ``tests/test_sp.py::test_cli_sp_eval_matches_plain``'s fake
ImageFolder and flags (``ttnet_imagenet_small`` at nfilter = tfilter = 4,
``--layers 0``, 224², two classes of four JPEGs, B = 8):

* ``--mode eval --sp`` on a 2x2 and a 1x4 mesh equals the port's
  unsharded run, and the JAX CLI's ``--sp`` run on its 8 CPU devices
  (data 2 x model 4) from the same weights;
* ``--sp --attack fgsm`` on the 2x2 mesh equals the unsharded run's
  adversarial top-1;
* the other families, in the same launch: on the 2x2 mesh v1
  (``TT_vf_19lv2_imgnet`` at p = 4, 224²) and ``cifar10lownoise --certify``
  (32², the CIFAR transform of the same JPEGs) equal the port's unsharded
  run and the JAX CLI's ``--sp`` run on its 8 CPU devices from the same
  weights; ``TT_FHE_small`` on the 1x4 mesh (random weights and coin
  flips from one ``--seed``) equals the port's unsharded run (its flips
  are torch's, not JAX's);
* the refusals, in-process: each of the JAX CLI's ``--sp`` texts word for
  word (a model axis of 1, ``--tp``, ``--lut`` and ``--gates``, a height
  the model axis does not divide, train, compile, and serve, which the
  port meets on a one-device mesh).
"""

import io
import json
import sys
import threading
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads, free_port, launch_ranks  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu import train as jtrain
from scale_imagenet_tpu.parallel import mesh as jmesh
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees

pytestmark = pytest.mark.usefixtures("few_threads")

RUNNER = "tests/_torch_main_rank.py"
WORLD = 4
WIDTH = ["--nfilter", "4", "--tfilter", "4", "--layers", "0"]
ATTACK = ["--attack", "fgsm", "--attack_eps", "0.01"]
# the other families' jobs: name -> (model flags, weights from this seed
# or None (``--seed`` alone), the 32x32 images, the model axis).
# ``TT_FHE_small`` runs on 1x4: one data index keys its flips as one
# process does (each data index of a 2x2 mesh keys its own, as under DP)
FAMILIES = {
    "v1": (["--model", "TT_vf_19lv2_imgnet", "--nfilter", "1", "--tfilter",
            "4"], 4, False, 2),
    "certify": (["--model", "cifar10lownoise", "--certify", "0.01"], 5,
                True, 2),
    "fhe": (["--model", "TT_FHE_small", "--nfilter", "1", "--tfilter", "8",
             "--seed", "6"], None, True, 4),
}


def _image_folder(root, side: tuple):
    """Two classes of four seeded JPEGs of ``side`` (height, width)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(2):
        d = root / "val" / f"n{c:08d}"
        d.mkdir(parents=True)
        for i in range(4):
            arr = rng.integers(0, 255, (*side, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img_{i}.jpg")
    return root


@pytest.fixture(scope="module")
def fake_val_dir(tmp_path_factory):
    """``tests/test_sp.py``'s ImageFolder: two classes of four 260x250
    JPEGs."""
    return _image_folder(tmp_path_factory.mktemp("sp_imagenet"), (260, 250))


@pytest.fixture(scope="module")
def cifar_val_dir(tmp_path_factory):
    """The same at 32x32, which the CIFAR eval transform takes as it is."""
    return _image_folder(tmp_path_factory.mktemp("sp_cifar"), (32, 32))


def _base(data, root) -> list:
    return ["--mode", "eval", "--data_dir", str(data), *WIDTH,
            "--eval_batch_size", "8", "--num_workers", "2", "--root_dir",
            str(root), "--log_interval", "1"]


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out
    return json.loads(line[0][len("RESULT "):])


def _one_process(argv):
    """``main`` in this process, its metrics logged to ``metrics.jsonl``
    alone (TensorBoard's first import takes seconds)."""
    with redirect_stdout(io.StringIO()), \
            mock.patch.dict(sys.modules, {"torch.utils.tensorboard": None}):
        return cli.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def runs(fake_val_dir, cifar_val_dir, tmp_path_factory):
    """The four ranks (started first: their jobs are ``--sp`` eval at 2x2
    and 1x4 and ``--sp --attack fgsm`` at 2x2, from one weights file),
    and meanwhile the port's unsharded runs and the JAX CLI's ``--sp`` run
    on the same weights."""
    work = tmp_path_factory.mktemp("sp_cli")
    models, flags = {}, {}
    for name, (extra, seed, cifar, _) in {"flagship": (
            ["--model", "ttnet_imagenet_small"], 3, False, 2),
            **FAMILIES}.items():
        flags[name] = _base(cifar_val_dir if cifar else fake_val_dir,
                            work) + extra
        if seed is not None:
            args = cli.parse_args(flags[name])
            models[name] = cli.get_model(args.model, nfilter=args.nfilter,
                                         tfilter=args.tfilter,
                                         layers=args.layers).init(
                seed=seed, device="cpu")
            weights = str(work / f"{name}.pth")
            torch.save(models[name].state_dict(), weights)
            flags[name] += ["--ckpt", weights]
    base = flags["flagship"]
    jobs = {"sp2x2": base + ["--mesh_model", "2", "--sp"],
            "sp1x4": base + ["--mesh_model", "4", "--sp"],
            "attack2x2": base + ["--mesh_model", "2", "--sp", *ATTACK],
            **{name: flags[name] + ["--mesh_model", str(spec[3]), "--sp"]
               for name, spec in FAMILIES.items()}}
    ports = [free_port() for _ in jobs]
    files = []
    for r in range(WORLD):
        files.append(work / f"jobs{r}.json")
        files[r].write_text(json.dumps([
            {"argv": argv + [
                "--device", "cpu", "--num_processes", str(WORLD),
                "--process_id", str(r), "--coordinator_address",
                f"localhost:{port}"]}
            for argv, port in zip(jobs.values(), ports)]))
    outs = {}
    ranks = threading.Thread(target=lambda: outs.setdefault(
        "logs", launch_ranks(lambda r: [RUNNER, str(files[r])],
                             world=WORLD)))
    ranks.start()
    jax_sp = {}
    for name, model in models.items():
        params, state = jax.tree.map(np.array, jax_trees(model))
        with mock.patch.object(jmain, "load_params",
                               lambda cfg, m: (params, state)), \
                redirect_stdout(io.StringIO()):
            argv = [a for a in flags[name] if not a.endswith(".pth")
                    and a != "--ckpt"]
            jax_sp[name] = jmain.main(argv + [
                "--mesh_data", "2", "--mesh_model", "4", "--sp"])
    plain = {name: _one_process(flags[name]) for name in flags}
    attacked = _one_process(base + ATTACK)
    ranks.join()
    assert "logs" in outs, "the ranks did not finish"
    split = [o.split("JOB ")[1:] for o in outs["logs"]]
    got = {k: [split[r][i] for r in range(WORLD)]
           for i, k in enumerate(jobs)}
    return got, plain, attacked, jax_sp


@pytest.mark.parametrize("job,mesh", [("sp2x2", "{'data': 2, 'model': 2}"),
                                      ("sp1x4", "{'data': 1, 'model': 4}")])
def test_sp_eval_equals_unsharded_and_the_jax_cli(runs, job, mesh):
    got, plain, _, jax_sp = runs
    outs = got[job]
    res = [_result(o) for o in outs]
    assert all(r == res[0] for r in res)
    assert f"mesh: {mesh} over 4 devices / 4 processes (gloo)" in outs[0]
    assert "scored 8 images over 4 ranks" in outs[0]
    assert all("final:" not in o for o in outs[1:])
    top1, top5, loss = res[0]
    assert (top1, top5) == plain["flagship"][:2]
    assert loss == pytest.approx(plain["flagship"][2], rel=1e-5)
    assert (top1, top5) == tuple(jax_sp["flagship"])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_other_families_equal_unsharded_and_the_jax_cli(runs, name):
    """``--mode eval --sp`` (2x2; ``TT_FHE_small`` 1x4): every rank's
    metrics equal, and equal to the unsharded run's in the bounds above
    (``cert`` too), and to the JAX CLI's ``--sp`` run where JAX draws no
    coin flips."""
    got, plain, _, jax_sp = runs
    outs = got[name]
    res = [_result(o) for o in outs]
    assert all(r == res[0] for r in res)
    m = FAMILIES[name][3]
    assert f"mesh: {{'data': {4 // m}, 'model': {m}}} over 4 devices" \
        in outs[0]
    assert "scored 8 images over 4 ranks" in outs[0]
    top1, top5, loss = res[0][:3]
    want = plain[name]
    assert (top1, top5) == want[:2]
    assert loss == pytest.approx(want[2], rel=1e-5)
    if name == "certify":
        assert res[0][3] == want[3] and set(want[3]) == {"cert"}
        assert "certified@eps=0.01" in outs[0]
    if name in jax_sp:
        assert (top1, top5) == tuple(jax_sp[name][:2])
        if name == "certify":
            assert res[0][3]["cert"] == jax_sp[name][2]["cert"]


def test_sp_attack_equals_unsharded(runs):
    got, _, attacked, _ = runs
    res = [_result(o) for o in got["attack2x2"]]
    assert all(r == res[0] for r in res)
    top1, top5, loss, extras = res[0]
    assert set(extras) == {"adv"}
    assert (top1, top5) == attacked[:2]
    assert extras["adv"] == attacked[3]["adv"]
    assert "adversarial@eps=0.01" in got["attack2x2"][0]


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
        jmain.main(argv)
    return err.value


REFUSED = {
    "mesh_model": ["--mesh_data", "1", "--sp"],
    "pick_one": ["--mesh_data", "2", "--mesh_model", "4", "--sp", "--tp"],
    "lut": ["--mesh_data", "2", "--mesh_model", "4", "--sp", "--lut"],
    "gates": ["--mesh_data", "2", "--mesh_model", "4", "--sp", "--gates",
              "dnf"],
    "height": ["--mesh_data", "2", "--mesh_model", "3", "--sp"],
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_eval_refusals_are_the_jax_texts(fake_val_dir, tmp_path, name):
    argv = _base(fake_val_dir, tmp_path) + REFUSED[name]
    want = _jax_error(argv)
    with pytest.raises(ValueError) as got:
        _one_process(argv)
    assert isinstance(want, ValueError) and str(got.value) == str(want)


@pytest.mark.parametrize("mode", ("train", "compile"))
def test_train_and_compile_refusals_are_the_jax_texts(fake_val_dir,
                                                      tmp_path, mode):
    argv = ["--mode", mode, "--sp", *WIDTH, "--data_dir",
            str(fake_val_dir), "--root_dir", str(tmp_path)]
    want = _jax_error(argv)
    with pytest.raises(ValueError) as got:
        _one_process(argv)
    assert isinstance(want, ValueError) and str(got.value) == str(want)
    assert ("EVAL" if mode == "train" else "truth-table") in str(want)


@pytest.mark.parametrize("extra", ([], ["--lut"]), ids=("conv", "lut"))
def test_serve_meets_the_jax_checks_on_one_device(tmp_path, extra):
    """The server is one process on one card: with a model axis of 1 the
    JAX CLI's serve texts; with a model axis of 2, ``make_mesh``'s refusal
    of a one-device mesh."""
    argv = ["--mode", "serve", "--sp", *WIDTH, "--root_dir", str(tmp_path),
            "--mesh_data", "1", *extra]
    want = _jax_error(argv)
    with pytest.raises(ValueError) as got:
        _one_process(argv)
    assert isinstance(want, ValueError) and str(got.value) == str(want)
    with pytest.raises(ValueError) as one_device:
        jmesh.make_mesh(1, 2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        _one_process(argv + ["--mesh_model", "2"])
    assert str(got.value) == str(one_device.value)
    assert "needs more than the 1 available devices" in str(got.value)

