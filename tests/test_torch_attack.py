"""White-box attacks (``robust/attack.py``, ``--attack fgsm|pgd``) of the
port against the JAX package on the CPU.

FGSM and PGD images match JAX's in f64 on the flagship at a small width and
on ``cifar10lownoise``: where the input gradient's magnitude is below
1e-12 a sign may differ, so those entries are counted (and must be the
only ones that differ); PGD steps a stochastic model's flips by the key
derivation (``noise.child(i)``); ``main --mode eval --attack pgd`` gives
the JAX CLI's metrics on the same weights and shards; with the fused
switch on, no differentiated forward goes through the fused kernel (the
clean one does), and the model's parameters carry no gradient.
"""

import io
from contextlib import redirect_stdout
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, few_threads, x64  # noqa: F401
from test_torch_cifar_zoo import zoo_pair
from test_torch_certify import _normalized, _shards

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.robust import attack as jattack
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from scale_imagenet_tpu_torch.models import block_tt
from scale_imagenet_tpu_torch.robust import attack
from scale_imagenet_tpu_torch.train import make_eval_step
from scale_imagenet_tpu_torch.train.steps import _pixel_ball

STATS = (IMAGENET_MEAN, IMAGENET_STD)
FLAGSHIP = ("ttnet_imagenet_small", dict(nfilter=2, tfilter=2, layers=1,
                                         image_size=64), 64)
LOWNOISE = ("cifar10lownoise", {}, 32)
STEPS = 2

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _case(name, kw, size, seed):
    jm, params, state, md, model = zoo_pair(name, kw, seed=seed)
    u = np.random.default_rng(seed + 1).uniform(size=(3, size, size, 3))
    x = (u - IMAGENET_MEAN) / IMAGENET_STD
    with torch.no_grad():
        labels = model(torch.from_numpy(x)).argmax(-1).numpy()
    labels[0] = (labels[0] + 1) % md.config.num_classes
    labels[-1] = -1                                   # a pad row
    ball = tuple(b.numpy().astype(np.float64)
                 for b in _pixel_ball(4 / 255, STATS))
    return jm, params, state, md, model, x, labels.astype(np.int32), ball


def _apply(jm, p, s):
    return lambda p_, s_, a, training=False, key=None: jm.apply(
        p_, s_, a, training=training, key=key)


def _compare(got, want, grads, step) -> int:
    """``got`` equals ``want`` but where a JAX input gradient of the attack
    was below 1e-12 in magnitude (not zero: both signs are 0 there); the
    count of such entries that differ."""
    apart = got != want
    tiny = np.zeros_like(apart)
    for g in grads:
        tiny |= (np.abs(g) < 1e-12) & (g != 0)
    assert not (apart & ~tiny).any(), step
    return int(apart.sum())


@pytest.mark.parametrize("case", [FLAGSHIP, LOWNOISE],
                         ids=["flagship", "cifar10lownoise"])
def test_fgsm_and_pgd_images_match_jax_f64(x64, case):  # noqa: F811
    jm, params, state, md, model, x, y, (eps, lo, hi) = _case(*case, seed=31)
    apply = _apply(jm, params, state)

    def jgrad(a):
        return jattack._loss_grad(apply, params, state, a, y, None)

    def jattacks(p, s, a):
        """JAX's FGSM and PGD images, and the input gradient of each
        step (for the tie count), in one program."""
        adv = jattack.pgd_attack(apply, p, s, a, y, eps, steps=STEPS, lo=lo,
                                 hi=hi)
        g, cur = [], a
        x_lo, x_hi = jnp.maximum(a - eps, lo), jnp.minimum(a + eps, hi)
        for _ in range(STEPS):
            g.append(jgrad(cur))
            cur = jnp.clip(cur + eps / 4 * jnp.sign(g[-1]), x_lo, x_hi)
        fgsm = jnp.clip(a + eps * jnp.sign(g[0]), lo, hi)
        return fgsm, jattack.fgsm_attack(apply, p, s, a, y, eps, lo, hi), \
            adv, g

    own_f, want_f, want_p, g_p = jax.jit(jattacks).lower(
        params, state, x).compile(_FAST_COMPILE)(params, state, x)
    np.testing.assert_array_equal(np.asarray(own_f), np.asarray(want_f))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ball = tuple(torch.from_numpy(b) for b in (eps, lo, hi))
    with attack.frozen(model):
        got_f = attack.fgsm_attack(model, xt, yt, *ball)
        got_p = attack.pgd_attack(model, xt, yt, ball[0], steps=STEPS,
                                  lo=ball[1], hi=ball[2])
    ties = _compare(got_f.numpy(), np.asarray(want_f), [np.asarray(g_p[0])],
                    "fgsm")
    ties += _compare(got_p.numpy(), np.asarray(want_p),
                     [np.asarray(g) for g in g_p], "pgd")
    assert ties <= 8
    # the attack moved the images, and the pad row's gradient is zero
    assert not np.array_equal(got_p.numpy(), x)
    np.testing.assert_array_equal(got_f.numpy()[-1], x[-1])
    assert all(p.requires_grad for p in model.parameters())


class _Path:
    """A key that records the child path of every draw."""

    def __init__(self, path=(), log=None):
        self.path, self.log = path, [] if log is None else log

    def child(self, index):
        return _Path(self.path + (index,), self.log)

    def draw(self, x):
        self.log.append(self.path)
        return torch.zeros_like(x)


def test_pgd_keys_a_stochastic_model_by_step():
    _, _, _, md, model = zoo_pair("tt_certif", dict(nfilter=1, tfilter=3),
                                  seed=33, dtype=np.float32)
    x = torch.from_numpy(_normalized(2, 34)).float()
    key = _Path()
    attack.pgd_attack(model, x, torch.tensor([1, 2]), 0.01, steps=2,
                      noise=key)
    # the pixel site of each step's forward: split(fold_in(key, i))[1]
    sites = [p for p in key.log if len(p) == 2]
    assert sites == [(0, 1), (1, 1)]
    assert {p[0] for p in key.log} == {0, 1}


def test_fused_kernel_only_in_undifferentiated_forwards():
    _, _, _, md, model = zoo_pair(*FLAGSHIP[:2], seed=35, dtype=np.float32)
    x = torch.from_numpy(_normalized(2, 36)[:, :16, :16].repeat(
        4, 1).repeat(4, 2)).float()
    calls = []
    real = block_tt.fused_pointwise_nchw

    def spy(h, *a, **k):
        calls.append(h.requires_grad and torch.is_grad_enabled())
        return real(h, *a, **k)

    step = make_eval_step(lambda a, **k: model(a, **k), md=md, model=model,
                          attack={"kind": "pgd", "eps": 4 / 255, "steps": 2})
    with mock.patch.object(config.performance, "fused_pointwise_blocks",
                           True), \
            mock.patch.object(block_tt, "fused_pointwise_nchw", spy):
        out = step(x, torch.tensor([0, 1]))
    # the clean and the adversarial forwards, each through the kernel's
    # k = 1 heads; none of the two differentiated ones
    assert len(calls) > 0 and not any(calls)
    assert set(out) == {"loss", "top1", "top5", "n", "adv"}
    assert all(p.requires_grad for p in model.parameters())


def test_cli_attack_pgd_matches_jax_cli(tmp_path):
    name = "cifar10lownoise"
    _, _, _, md, model = zoo_pair(name, {}, seed=37, dtype=np.float32)
    params, state = jax.tree.map(np.array, jax_trees(model))
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    base = ["--mode", "eval", "--model", name, "--shards_dir",
            _shards(model, tmp_path), "--eval_batch_size", "5",
            "--attack", "pgd", "--attack_eps", "0.002", "--attack_steps",
            "3", "--root_dir", str(tmp_path)]
    with redirect_stdout(io.StringIO()) as out:
        got = cli.main(base + ["--device", "cpu", "--ckpt", weights])
    assert "adversarial@eps=0.002" in out.getvalue()
    with mock.patch.object(jmain, "load_params",
                           lambda cfg, m: (params, state)), \
            redirect_stdout(io.StringIO()):
        want = jmain.main(base + ["--mesh_data", "1"])
    top1, top5, _, extras = got
    assert (top1, top5) == tuple(want[:2])
    assert extras == want[2] and set(extras) == {"adv"}
    assert extras["adv"] < top1
