"""The CIFAR zoo (``models/ttnet_cifar.py``) against the JAX package on the
CPU in f64 (its primitives are in ``tests/test_torch_zoo_ops.py``).

The f64 logits of every ``mobilenet_v2_tt`` variant and of
``mobilenet_v1_tt`` at a small width (each variant's ``(n, t)`` set to a
small pair in both packages' stage tables for the test; the registry
widths are built and loaded in ``tests/test_torch_zoo_cli.py``),
``model_general`` (its ``ter``, ``bin`` and ``float`` stems and heads) and
``cifar10lownoise`` match to 1e-9, with JAX's weights carried across
(``port_and_trees``: the port's seeded weights, BN statistics perturbed,
as the JAX trees; the stats BNs given spread statistics); two f64 train
steps of ``model_general`` and ``cifar10lownoise`` match
``make_train_step`` to 1e-9 (the mobilenets' in
``tests/test_torch_mobilenet_train.py``).
"""

import contextlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, few_threads, images, \
    jax_train_steps, port_and_trees, x64  # noqa: F401

from scale_imagenet_tpu.models import ttnet_cifar as jcifar
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch.models import ttnet_cifar as pcifar
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.layers import StatsBN
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

TOL = dict(rtol=1e-9, atol=1e-9)

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def stats_bn_nonzero(model, seed: int) -> None:
    """Positive running variances and spread means on every ``StatsBN``
    (a fresh one divides by sqrt(eps))."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, StatsBN):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 3)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) * 50 + 10)


def zoo_pair(name: str, kw: dict, seed: int, dtype=np.float64):
    """``port_and_trees`` with the stats BNs' statistics spread."""
    jm, _, _, md, model = port_and_trees(name, dtype, seed=seed, **kw)
    stats_bn_nonzero(model, seed)
    params, state = jax.tree.map(np.array, jax_trees(model))
    return jm, params, state, md, model


def assert_trees_match(got, want, rtol=1e-9, atol=1e-12) -> None:
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# a small (n, t) a mobilenet_v2 variant: p divisible by its head and fuse
# head group divisors (the registry's p = 60 and 64 take XLA's f64 grouped
# convs a minute at the TT_50 pair's 16p stages)
SMALL_NT = {"mobilenet_v2": (2, 6), "small": (2, 4), "small_n64": (2, 4),
            "small_n64bis": (2, 4), "32_64": (2, 4), "32_32": (2, 4)}


@contextlib.contextmanager
def small_v2(name: str):
    """The variant of ``name`` at ``SMALL_NT``'s width in both packages."""
    variant = {"mobilenet_v2_tt": "mobilenet_v2"}.get(
        name, name.replace("mobilenet_v2_tt_", ""))
    if not name.startswith("mobilenet_v2"):
        yield
        return
    n, t = SMALL_NT[variant]
    with mock.patch.dict(jcifar._V2_STAGES, {
            variant: (n, t, jcifar._V2_STAGES[variant][2])}), \
            mock.patch.dict(pcifar.V2_STAGES, {
                variant: (n, t, pcifar.V2_STAGES[variant][2])}):
        yield


# (name, registry kwargs): every class and stem/head kind of the file
ZOO = [("mobilenet_v2_tt", {}), ("mobilenet_v2_tt_small", {}),
       ("mobilenet_v2_tt_small_n64", {}), ("mobilenet_v2_tt_small_n64bis", {}),
       ("mobilenet_v2_tt_32_64", {}), ("mobilenet_v2_tt_32_32", {}),
       ("mobilenet_v1_tt", dict(n=2, t=2)), ("model_general", {}),
       ("model_general", dict(type_weights_preprocessing="bin",
                              type_weights_final="ter")),
       ("model_general", dict(type_weights_preprocessing="float",
                              type_weights_final="float",
                              use_scalar_scale_last_layer=False)),
       ("cifar10lownoise", {})]


@pytest.mark.parametrize("name,kw", ZOO,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ZOO)])
def test_zoo_logits_match_jax_f64(x64, name, kw):  # noqa: F811
    with small_v2(name):
        jm, params, state, md, model = zoo_pair(name, kw, seed=3)
        x = images((2, 32, 32, 3), 12)
        fwd = jax.jit(lambda p, s, a: jm.apply(p, s, a)[0])
        want = np.asarray(fwd.lower(params, state, x).compile(
            _FAST_COMPILE)(params, state, x))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **TOL)


def assert_two_steps_match(name: str, kw: dict, lr: float, batch: int,
                           atol: float = 1e-12) -> tuple:
    """Two f64 SGD steps at ``lr`` of ``name`` (``small_v2``'s width) on
    seeded ``batch``-image batches match JAX's ``make_train_step``: the
    metrics to 1e-9, the trees to 1e-9 relative and ``atol``.  Returns
    the start and end trees ``(params, got_params, state, got_state)``."""
    opt_kw = dict(lr=lr, milestones=(1,), steps_per_epoch=1)
    with small_v2(name):
        jm, params, state, md, model = zoo_pair(name, kw, seed=5)
        rng = np.random.default_rng(13)
        batches = [(rng.uniform(0, 1, (batch, 32, 32, 3)),
                    rng.integers(0, 10, batch).astype(np.int32))
                   for _ in range(2)]
        tx, _ = jmake_optimizer(**opt_kw)
        jparams, jstate, jmetrics, _ = jax_train_steps(jm, tx, params,
                                                       state, batches)
        opt, _ = make_optimizer(**opt_kw)
        ts = TrainState(model, opt.init(dict(model.named_parameters())))
        step = make_train_step(model, opt)
        for (x, y), want in zip(batches, jmetrics):
            ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y))
            for k, v in want.items():
                np.testing.assert_allclose(float(m[k]), v, **TOL, err_msg=k)
        got_p, got_s = jax_trees(ts.model)
    assert_trees_match(got_p, jparams, atol=atol)
    assert_trees_match(got_s, jstate, atol=atol)
    # the steps moved the weights (the port's too: the trees are equal)
    assert any(not np.array_equal(w, a) for w, a in zip(
        jax.tree.leaves(jparams), jax.tree.leaves(params)))
    return params, got_p, state, got_s


@pytest.mark.parametrize("name", ["model_general", "cifar10lownoise"])
def test_two_train_steps_match_jax(x64, name):  # noqa: F811
    params, got_p, state, got_s = assert_two_steps_match(name, {}, 0.05, 4)
    # the binarized head and its mask moved, and the stats BN's statistics
    assert not np.array_equal(got_p["fc"]["weight"], params["fc"]["weight"])
    assert not np.array_equal(got_s["head_bn"]["running_var"],
                              state["head_bn"]["running_var"])
