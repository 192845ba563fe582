"""``tt_certif`` (``models/tt_certif.py``) against the JAX package on the
CPU, with JAX's coin flips recorded and replayed (``_torch_port.Replay``).

The f64 logits of both heads (the Linear and ``binpos_v2``) match to 1e-9;
two f64 train steps match ``make_train_step`` to 1e-9; the draw sites ask
their ``NoiseKey`` in JAX's key order (``split`` for the pixel site,
``fold_in`` a block, ``split(., 3)`` its heads); ``main --mode eval`` gives
equal metrics twice from one ``--seed`` and other ones from another, and
``--mode serve`` answers finite, well-formed top-5 lists.
"""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from _torch_port import Replay, _FAST_COMPILE, few_threads, images, \
    jax_train_steps, port_and_trees, recorded_bernoulli, x64  # noqa: F401
from test_torch_cifar_zoo import assert_trees_match
from test_torch_v1_models import _serve

from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.ops import NoiseKey
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

TOL = dict(rtol=1e-9, atol=1e-9)
P3 = dict(nfilter=1, tfilter=3)
SITES = 1 + 3 * 3          # the pixels, then three heads a block

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("head", ["linear", "binpos_v2"])
def test_logits_match_jax_f64_with_replayed_flips(x64, head):  # noqa: F811
    jm, params, state, md, model = port_and_trees("tt_certif", seed=2,
                                                  head=head, **P3)
    assert md.stochastic
    x = images((2, 32, 32, 3), 3)
    fwd = jax.jit(lambda p, s, a, k: jm.apply(p, s, a, key=k)[0])
    with recorded_bernoulli() as draws:
        want = np.asarray(fwd.lower(params, state, x, jax.random.PRNGKey(
            4)).compile(_FAST_COMPILE)(params, state, x,
                                       jax.random.PRNGKey(4)))
    assert len(draws) == SITES
    replay = Replay(draws)
    with torch.no_grad():
        got = model(torch.from_numpy(x), noise=replay).numpy()
    assert replay.used == SITES
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="needs a noise key"):
        model(torch.from_numpy(x))


class _Path(NoiseKey):
    """A key that records the child path of every draw."""

    def __init__(self, path=(), log=None):
        super().__init__(0)
        self.path, self.log = path, [] if log is None else log

    def child(self, index):
        return _Path(self.path + (index,), self.log)

    def draw(self, x):
        self.log.append(self.path)
        return torch.zeros_like(x)


def test_draw_sites_follow_the_jax_key_order():
    _, _, _, md, model = port_and_trees("tt_certif", np.float32, **P3)
    key = _Path()
    with torch.no_grad():
        model(torch.rand(1, 32, 32, 3), noise=key)
    # split(key) -> (key', k0): the pixels k0; block i fold_in(key', i),
    # its heads split(., 3)
    assert key.log == [(1,)] + [(0, i, j) for i in range(3)
                                for j in range(3)]


def test_two_train_steps_match_jax_with_replayed_flips(x64):  # noqa: F811
    opt_kw = dict(lr=0.05, milestones=(1,), steps_per_epoch=1)
    jm, params, state, md, model = port_and_trees("tt_certif", seed=5, **P3)
    rng = np.random.default_rng(6)
    batches = [(rng.uniform(0, 1, (4, 32, 32, 3)),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(2)]
    tx, _ = jmake_optimizer(**opt_kw)
    with recorded_bernoulli() as draws:
        jparams, jstate, jmetrics, _ = jax_train_steps(
            jm, tx, params, state, batches,
            keys=[jax.random.PRNGKey(7), jax.random.PRNGKey(8)])
    assert len(draws) == 2 * SITES
    opt, _ = make_optimizer(**opt_kw)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for i, ((x, y), want) in enumerate(zip(batches, jmetrics)):
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y),
                     noise=Replay(draws[i * SITES:(i + 1) * SITES]))
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, **TOL, err_msg=k)
    got_p, got_s = jax_trees(ts.model)
    assert_trees_match(got_p, jparams)
    assert_trees_match(got_s, jstate)


def test_main_eval_is_repeatable_from_its_seed_and_serves(tmp_path):
    rng = np.random.default_rng(8)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, 6).astype(np.int32)), str(tmp_path / "s"))
    base = ["--model", "tt_certif", "--nfilter", "1", "--tfilter", "3",
            "--device", "cpu", "--root_dir", str(tmp_path / "run")]
    ev = ["--mode", "eval", *base, "--shards_dir", str(tmp_path / "s"),
          "--eval_batch_size", "4"]
    with redirect_stdout(io.StringIO()):
        a = cli.main(ev + ["--seed", "3"])
        b = cli.main(ev + ["--seed", "3"])
        c = cli.main(ev + ["--seed", "4", "--model_arg", "head=binpos_v2"])
        train = cli.main(["--mode", "train", *base, "--shards_dir",
                          str(tmp_path / "s"), "--train_batch_size", "3",
                          "--max_epochs", "1"])
    assert a == b and a != c and np.isfinite(a[2]) and np.isfinite(c[2])
    assert train["step"] == 2
    xs = images((3, 32, 32, 3), 9).astype(np.float32)
    for top5 in _serve(base, xs):
        assert len(top5) == 5 and len(set(top5)) == 5
        assert all(0 <= k < 10 for k in top5)
