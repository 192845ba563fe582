"""Robust training (``train/steps.py::make_robust_train_step``, ``--mode
train --stability_eps/--abstract_eps/--bias_decay``) against the JAX
package on the CPU.

Two consecutive f64 robust steps (momentum, weight decay, an LR milestone
between them) give the loss, top-1/5, stability loss, parameters and BN
running statistics of JAX's ``make_robust_train_step`` to 1e-9: each of
the three losses alone and the three composed on ``cifar10lownoise`` (the
composed case from images normalized on the host, as the ImageFolder
route feeds them, with their per-channel ``input_bounds`` clamping the
eps-ball), and ``--stability_eps`` on the flagship at a small width.  (The
device's uint8 normalization runs in f32 on both sides, where an f64
model's batch statistics would differ at f32 precision; ``main --mode
train`` runs it from shards.)  JAX draws the multi-sample signs; they
are replayed into the port's key.  The CLI's side is in
``tests/test_torch_robust_cli.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, few_threads, images, \
    x64  # noqa: F401
from test_torch_cifar_zoo import assert_trees_match, zoo_pair

from scale_imagenet_tpu.train import TrainState as JTrainState
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu.train.steps import make_robust_train_step as jstep
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_robust_train_step

TOL = dict(rtol=1e-9, atol=1e-9)
OPT = dict(lr=0.05, milestones=(1,), steps_per_epoch=1)
B = 2
BOUNDS = ((0.0 - IMAGENET_MEAN) / IMAGENET_STD,
          (1.0 - IMAGENET_MEAN) / IMAGENET_STD)

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


class _Key:
    """The port's key of one step: ``child(0)`` draws JAX's signs."""

    def __init__(self, signs):
        self.signs = signs

    def child(self, index):
        return self

    def draw(self, x):
        return torch.from_numpy(self.signs).to(x)


# (name, registry kwargs, image size, the step's keywords, normalized
# images)
CASES = {
    "stability": ("cifar10lownoise", {}, 32, dict(eps=0.02, coeff=0.01),
                  False),
    "abstract": ("cifar10lownoise", {}, 32,
                 dict(eps=0.0, coeff=0.0, abstract_eps=0.01,
                      abstract_coeff=0.01), False),
    "bias": ("cifar10lownoise", {}, 32,
             dict(eps=0.0, coeff=0.0, bias_coeff=0.05, bias_thresh=0.5),
             False),
    "composed": ("cifar10lownoise", {}, 32,
                 dict(eps=0.05, coeff=0.01, abstract_eps=0.01,
                      abstract_coeff=0.01, bias_coeff=0.05, bias_thresh=0.5,
                      input_bounds=BOUNDS), True),
    "flagship_stability": ("ttnet_imagenet_small",
                           dict(nfilter=2, tfilter=2, layers=1,
                                image_size=64), 64,
                           dict(eps=0.02, coeff=0.01), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_robust_steps_match_jax_f64(x64, case):  # noqa: F811
    name, kw, size, step_kw, normalized = CASES[case]
    jm, params, state, md, model = zoo_pair(name, kw, seed=41)
    rng = np.random.default_rng(42)
    xs = [images((B, size, size, 3), s) for s in (43, 44)]
    if normalized:
        # with pixels at 0 and 1, where the ball's clamps bite
        xs = [(np.round(x * 4) / 4 - IMAGENET_MEAN) / IMAGENET_STD
              for x in xs]
    batches = [(x, rng.integers(0, md.config.num_classes, B).astype(
        np.int32)) for x in xs]
    keys = [jax.random.PRNGKey(i) for i in (45, 46)]
    eps, coeff = step_kw["eps"], step_kw["coeff"]
    rest = {k: v for k, v in step_kw.items() if k not in ("eps", "coeff")}

    tx, _ = jmake_optimizer(**OPT)
    p = jax.tree.map(jnp.array, params)
    ts = JTrainState(p, jax.tree.map(jnp.array, state), tx.init(p),
                     jnp.zeros((), jnp.int32))
    step = jstep(jm, tx, eps, coeff, **rest)
    compiled = step.lower(ts, *batches[0], keys[0]).compile(_FAST_COMPILE)
    want = []
    for (x, y), k in zip(batches, keys):
        ts, m = compiled(ts, x, y, k)
        want.append({n: float(v) for n, v in m.items()})

    opt, _ = make_optimizer(**OPT)
    pts = TrainState(model, opt.init(dict(model.named_parameters())))
    pstep = make_robust_train_step(md, model, opt, eps, coeff, **rest)
    for (x, y), k, w in zip(batches, keys, want):
        # the signs of JAX's pack: randint(split(key)[0])
        signs = np.asarray(jax.random.randint(
            jax.random.split(k)[0], x.shape, 0, 2)).astype(np.float64)
        pts, m = pstep(pts, torch.from_numpy(x), torch.from_numpy(y),
                       noise=_Key(signs))
        assert set(m) == set(w)
        for n, v in w.items():
            np.testing.assert_allclose(float(m[n]), v, **TOL, err_msg=n)
    if eps > 0 or "abstract_eps" in rest:
        assert want[0]["stability_loss"] > 0
    got_p, got_s = jax_trees(pts.model)
    assert_trees_match(got_p, jax.tree.map(np.asarray, ts.params))
    assert_trees_match(got_s, jax.tree.map(np.asarray, ts.model_state))
