"""The v1 family's 32x32 clones as whole models against the JAX package on
the CPU (the parts are in ``tests/test_torch_v1.py``).

The port's seeded model (BN statistics perturbed) feeds both sides
through ``convert/from_jax.py``'s inverse map (``port_and_trees``): each of
the ten ``_cifar`` clones' f64 logits match ``ttnet_v1_apply`` to 1e-9 at
p = 4; two f64 train steps of ``TT_vf_19lv2_cifar`` (momentum, weight
decay and an LR milestone between them) match ``make_train_step``'s loss,
top-1/5, parameters and BN statistics to 1e-9; a ``state_dict_from_jax``
file goes through ``--ckpt`` strict, and ``main`` evaluates, trains and
serves the model.
"""

import io
import json
import threading
import urllib.request
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, images, jax_train_steps, \
    port_and_trees, x64  # noqa: F401
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees, state_dict_from_jax
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet_v1 import V1_STAGES, \
    cifar_name
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

TOL = dict(rtol=1e-9, atol=1e-9)
W = dict(nfilter=2, tfilter=2)
NAME = "TT_vf_19lv2_cifar"


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", [cifar_name(n) for n in V1_STAGES])
def test_cifar_clone_logits_match_jax_f64(x64, name):  # noqa: F811
    jm, params, state, md, model = port_and_trees(name, seed=2, **W)
    x = images((2, 32, 32, 3), 6) * 2 - 1
    fwd = jax.jit(lambda p, s, a: jm.apply(p, s, a)[0])
    want = fwd.lower(params, state, x).compile(_FAST_COMPILE)(params,
                                                              state, x)
    with torch.no_grad():
        got = model(_t(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_two_train_steps_match_jax(x64):  # noqa: F811
    opt_kw = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
    jm, params, state, md, model = port_and_trees(NAME, seed=5, **W)
    rng = np.random.default_rng(6)
    batches = [(rng.uniform(-1, 1, (4, 32, 32, 3)),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(2)]
    tx, _ = jmake_optimizer(**opt_kw)
    jparams, jstate, jmetrics, _ = jax_train_steps(jm, tx, params, state,
                                                   batches)
    opt, _ = make_optimizer(**opt_kw)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for (x, y), want in zip(batches, jmetrics):
        ts, m = step(ts, _t(x), _t(y))
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, **TOL, err_msg=k)
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
    # every parameter moved, the stem's and the fc's among them
    assert not np.array_equal(got_p["stem_conv"]["weight"],
                              params["stem_conv"]["weight"])
    assert not np.array_equal(got_p["fc"]["bias"], params["fc"]["bias"])


def _serve(argv: list, xs: np.ndarray) -> list:
    """``main --mode serve`` in a thread; the top-5 of each request."""
    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            with redirect_stdout(io.StringIO()):
                cli.main(["--mode", "serve", *argv, "--port", "0",
                          "--serve_batch", "2"],
                         serve_ready=ready, serve_stop=stop)
        except Exception as e:                  # surfaced below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        assert ready.wait(120) and not errors, errors
        answers = []
        for xi in xs:
            req = urllib.request.Request(
                f"http://127.0.0.1:{ready.port}/predict", data=xi.tobytes(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read())["top5"])
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive() and not errors
    return answers


def test_ckpt_round_trips_strict_and_main_runs(tmp_path):
    """``--ckpt`` of a ``state_dict_from_jax`` file loads strict (the
    unread ``grad_scale``/``num_batches_tracked`` buffers may be absent,
    as in a reference file; any other key stays strict), and ``main``
    evaluates, trains and serves the model from 32x32 inputs."""
    _, params, state, md, model = port_and_trees(NAME, np.float32, seed=3,
                                                 **W)
    path = str(tmp_path / "v1.pth")
    sd = state_dict_from_jax(params, state, md.config)
    torch.save(sd, path)
    fresh = get_model(NAME, **W).init(seed=1, device="cpu")
    cli.load_checkpoint(fresh, path)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    lean = {k: v for k, v in sd.items()
            if not k.endswith(("grad_scale", "num_batches_tracked"))}
    assert len(lean) < len(sd)
    torch.save(lean, str(tmp_path / "lean.pth"))
    cli.load_checkpoint(fresh, str(tmp_path / "lean.pth"))
    torch.save({**sd, "features.1.bias": sd["features.2.bias"]},
               str(tmp_path / "bad.pth"))
    with pytest.raises(RuntimeError, match="features.1.bias"):
        cli.load_checkpoint(fresh, str(tmp_path / "bad.pth"))
    rng = np.random.default_rng(2)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, 6).astype(np.int32)), str(tmp_path / "s"))
    base = ["--model", NAME, "--nfilter", "2", "--tfilter", "2", "--device",
            "cpu", "--root_dir", str(tmp_path / "run"), "--ckpt", path]
    with redirect_stdout(io.StringIO()):
        top1, top5, loss = cli.main(["--mode", "eval", *base, "--shards_dir",
                                     str(tmp_path / "s"),
                                     "--eval_batch_size", "4"])
        summary = cli.main(["--mode", "train", *base, "--shards_dir",
                            str(tmp_path / "s"), "--train_batch_size", "3",
                            "--max_epochs", "1"])
    assert np.isfinite(loss) and 0 <= top1 <= top5 <= 100
    assert summary["step"] == 2
    xs = (images((2, 32, 32, 3), 8) * 2 - 1).astype(np.float32)
    with torch.no_grad():
        direct = torch.topk(torch.softmax(model(_t(xs)), -1), 5).indices
    assert _serve(base, xs) == direct.tolist()
