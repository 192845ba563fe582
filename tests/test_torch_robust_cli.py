"""The robust CLI flags (``--certify``, ``--attack``, ``--stability_eps``,
``--abstract_eps``, ``--bias_decay``) of the port's ``main`` against the JAX
CLI on the CPU: every refusal in train, eval, serve, export and compile
carries the JAX CLI's text (its robust-training checks, its ``--certify`` /
``--attack`` eval checks, ``--bias_decay`` on a model without a stats BN
at the first step), and ``main --mode train`` runs the three losses
composed from 32x32 uint8 shards (normalized on the device).
"""

import io
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest

from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _zero_params(cfg, model):
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        jax.eval_shape(model.init, jax.random.PRNGKey(0)))


def _jax_error(argv):
    """The error the JAX CLI raises for ``argv`` (zero weights of the
    init's shapes: its op-by-op init takes seconds)."""
    with mock.patch.object(jmain, "load_params", _zero_params), \
            pytest.raises(Exception) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--mesh_data", "1"])
    return err.value


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    path = tmp_path_factory.mktemp("robust") / "shards"
    rng = np.random.default_rng(47)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, 8).astype(np.int32)), str(path))
    return str(path)


REFUSED = [
    # training: the plain step's options, and a loss the model cannot take
    ("train", "cifar10lownoise", ["--stability_eps", "0.1", "--amp"]),
    ("train", "cifar10lownoise", ["--bias_decay", "0.1", "--grad_accum",
                                  "2"]),
    ("train", "cifar10lownoise", ["--abstract_eps", "0.1", "--label_smooth",
                                  "0.1"]),
    ("train", "mobilenet_v1_tt", ["--abstract_eps", "0.1"]),
    ("train", "cifar10lownoise", ["--certify", "0.1"]),
    ("train", "cifar10lownoise", ["--attack_eps", "0.1"]),
    # eval: training flags, and what --certify/--attack cannot apply to
    ("eval", "cifar10lownoise", ["--stability_eps", "0.1"]),
    ("eval", "cifar10lownoise", ["--certify", "0.1", "--bf16"]),
    ("eval", "cifar10lownoise", ["--certify", "0.1", "--lut"]),
    ("eval", "cifar10lownoise", ["--attack", "pgd"]),
    ("eval", "cifar10lownoise", ["--attack_lr", "0.1"]),
    ("eval", "cifar10lownoise", ["--attack", "fgsm", "--attack_eps", "0.1",
                                 "--fold_bn"]),
    ("eval", "cifar10lownoise", ["--attack", "fgsm", "--attack_eps", "0.1",
                                 "--gates", "dnf"]),
    # serve, export, compile
    ("serve", "cifar10lownoise", ["--attack", "pgd"]),
    ("serve", "cifar10lownoise", ["--bias_decay", "0.1"]),
    ("export", "cifar10lownoise", ["--certify", "0.1"]),
    ("export", "cifar10lownoise", ["--abstract_eps", "0.1"]),
    ("compile", "cifar10lownoise", ["--attack", "pgd"]),
]


@pytest.mark.parametrize("mode,name,argv", REFUSED,
                         ids=[f"{m}-{'_'.join(a)}" for m, _, a in REFUSED])
def test_refusals_are_the_jax_messages(shards, tmp_path, mode, name, argv):
    base = ["--mode", mode, "--model", name, "--root_dir", str(tmp_path),
            *argv]
    if mode in ("train", "eval"):
        base += ["--shards_dir", shards, "--train_batch_size", "4"]
    if name == "mobilenet_v1_tt":
        base += ["--model_arg", "n=1", "--model_arg", "t=2"]
    want = _jax_error(base)
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(base + ["--device", "cpu"])
    assert isinstance(want, ValueError) and str(got.value) == str(want)


def test_bias_decay_refused_without_stats_bn(shards, tmp_path):
    """mobilenet_v1_tt has no stats BN: the regulariser would add nothing,
    and both CLIs refuse it at the first step."""
    base = ["--mode", "train", "--model", "mobilenet_v1_tt", "--model_arg",
            "n=1", "--model_arg", "t=2", "--shards_dir", shards,
            "--train_batch_size", "4", "--bias_decay", "0.1", "--root_dir",
            str(tmp_path)]
    want = _jax_error(base)
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(base + ["--device", "cpu"])
    assert str(got.value) == str(want) and "stats_bn" in str(want)


def test_main_train_with_the_three_losses(shards, tmp_path):
    with redirect_stdout(io.StringIO()) as out:
        got = cli.main(["--mode", "train", "--device", "cpu", "--model",
                        "cifar10lownoise", "--shards_dir", shards,
                        "--train_batch_size", "4", "--max_epochs", "1",
                        "--stability_eps", "0.01", "--abstract_eps", "0.01",
                        "--bias_decay", "1e-3", "--log_interval", "1",
                        "--root_dir", str(tmp_path)])
    assert got["step"] == 2 and "stability_loss" in out.getvalue()
    for _, loss, _, sloss in got["train"]:
        assert np.isfinite(loss) and sloss > 0
