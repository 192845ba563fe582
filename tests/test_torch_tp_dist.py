"""Tensor parallelism over two real gloo ranks (a 1x2 mesh, one launch of
``tests/_torch_tp_worker.py`` for the file) against the JAX package's
``shard_map`` TP steps on a 1x2 mesh of the conftest's virtual CPU
devices, in f64 (``scale_imagenet_tpu_torch/parallel/tp.py``):

* the TP eval step's metrics equal ``make_tp_eval_step``'s, and the TP
  ``--lut`` step's (each rank its slice of the whole model's tables)
  ``make_tp_lut_eval_step``'s, to 1e-9;
* two TP train steps with ``accum = 2`` and the EMA equal JAX's
  ``make_tp_train_step`` (params, EMA and BN statistics to 1e-9, the loss
  to 1e-10, as ``tests/test_tp.py`` holds JAX's own), and the gathered
  train state equals the port's one-process ``make_train_step``'s to 1e-9
  (which ``tests/test_torch_train.py`` holds against JAX's
  ``make_train_step``: so the TP steps equal JAX's one-device steps
  too); the two ranks' replicated leaves (the classifier's BN and
  ``lin2``) are bit-equal;
* the collectives of JAX's TP step on a 2x2 mesh SUM the gradient of a
  data-replicated parameter over ``data`` (queue C, beside its
  data-parallel steps'); the port takes the mean.
"""

import threading
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_port import few_threads, free_port, launch_ranks, \
    port_and_trees  # noqa: F401
from test_torch_cifar_zoo import assert_trees_match

from scale_imagenet_tpu.compile import lut_eval as jlut
from scale_imagenet_tpu.compile import truth_table as jtruth
from scale_imagenet_tpu.parallel import mesh as jmesh
from scale_imagenet_tpu.parallel import tp as jtp
from scale_imagenet_tpu.train import TrainState as JTrainState
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu.train.optim import get_ema as jget_ema
from scale_imagenet_tpu.train.optim import params_ema as jparams_ema
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step, params_ema

pytestmark = pytest.mark.usefixtures("few_threads")

P32 = dict(nfilter=8, tfilter=4, layers=0, image_size=64)
OPT = dict(lr=0.1, milestones=(100,), steps_per_epoch=1)
EMA = 0.9
ACCUM = 2
STEPS = 2


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _batch(seed, classes=1000):
    """Images on a 1/256 grid."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (4, 64, 64, 3)) / 256.0
    return x, rng.integers(0, classes, 4).astype(np.int32)


def _mesh(data=1):
    return jmesh.make_mesh(data, 2, devices=jax.devices()[:2 * data])


def _placed(mesh, x, y):
    return (jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data", None, None, None))),
            jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("data"))))


def _jax_eval(make, jm, params, state, x, y, luts=None):
    mesh = _mesh()
    # JAX's LUT forward casts the images, the bits entering the float fuse
    # head and the features to f32 (``tp.py:232``, ``lut_eval.py:266,428``),
    # which its f64 convs refuse under x64: traced here with those casts at
    # f64 (the bits are exact in both)
    f64 = types.SimpleNamespace(**{**vars(jnp), "float32": jnp.float64})
    with mesh, mock.patch.object(jtp, "jnp", f64), \
            mock.patch.object(jlut, "jnp", f64):
        sp = jtp.shard_params_tp(params, mesh)
        if luts is not None:
            sp = {"model": sp, "luts": jtp.shard_luts_tp(luts, mesh)}
        m = make(jm, mesh)(sp, jtp.shard_params_tp(state, mesh),
                           *_placed(mesh, x, y))
    return {k: float(v) for k, v in m.items()}


def _jax_tp_train(jm, tx, params, state, x, y, data=1, steps=STEPS):
    """``steps`` TP train steps on a ``data`` x 2 mesh: ``(params, state,
    ema, metrics)`` as numpy trees (whole arrays) and floats."""
    mesh = _mesh(data)
    with mesh:
        p = jax.tree.map(jnp.array, params)
        ts = jtp.shard_train_state_tp(JTrainState(
            p, jax.tree.map(jnp.array, state), tx.init(p),
            jnp.zeros((), jnp.int32)), mesh)
        step = jtp.make_tp_train_step(jm, tx, mesh, accum=ACCUM)
        xs, ys = _placed(mesh, x, y)
        metrics = []
        for _ in range(steps):
            ts, m = step(ts, xs, ys, None)
            metrics.append({k: float(v) for k, v in m.items()})
    ema = jget_ema(ts.opt_state)
    return (jax.tree.map(np.asarray, ts.params),
            jax.tree.map(np.asarray, ts.model_state),
            None if ema is None else jax.tree.map(np.asarray, ema), metrics)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory, x64_module):
    """The two ranks (started first) and, meanwhile, JAX's steps and the
    port's one-process step."""
    work = tmp_path_factory.mktemp("tp")
    jm, params, state, md, model = port_and_trees(
        "ttnet_imagenet_small", **P32)
    ljm, lparams, lstate, lmd, lmodel = port_and_trees(
        "ttnet_imagenet_xsmall", seed=1, **P32)
    x, y = _batch(51)
    small = dict(name="ttnet_imagenet_small", kw=P32,
                 state=model.state_dict(), x=torch.from_numpy(x),
                 y=torch.from_numpy(y))
    torch.save({"conv": small,
                "lut": dict(small, name="ttnet_imagenet_xsmall",
                            state=lmodel.state_dict()),
                "train": dict(small, accum=ACCUM, steps=STEPS),
                "opt": OPT, "ema": EMA}, work / "job.pt")
    address = f"localhost:{free_port()}"
    outs = {}
    ranks = threading.Thread(target=lambda: outs.setdefault(
        "logs", launch_ranks(lambda r: [
            "tests/_torch_tp_worker.py", str(r), "2", address,
            str(work / "job.pt"), str(work)])))
    ranks.start()
    want = {"conv": _jax_eval(jtp.make_tp_eval_step, jm, params, state, x,
                              y)}
    # JAX enumerates its patterns in f32, which its f64 blocks refuse
    # under x64: enumerated here at f64 (the bits are exact in both)
    real = jtruth.enumerate_patterns
    with mock.patch.object(jtruth, "enumerate_patterns",
                           lambda cfg: real(cfg).astype(np.float64)):
        jluts = jlut.compile_ttnet_lut(jax.tree.map(jnp.asarray, lparams),
                                       jax.tree.map(jnp.asarray, lstate),
                                       ljm.config)
    want["lut"] = _jax_eval(jtp.make_tp_lut_eval_step, ljm, lparams, lstate,
                            x, y, luts=jluts)
    base, _ = jmake_optimizer(**OPT)
    tx = optax.chain(base, jparams_ema(EMA))
    want["tp"] = _jax_tp_train(jm, tx, params, state, x, y)
    # the port's one-process step from the same weights
    opt, _ = make_optimizer(**OPT)
    opt = type(opt)(opt.schedule, opt.momentum, opt.weight_decay,
                    params_ema(EMA))
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt, accum=ACCUM)
    one = []
    with torch.enable_grad():
        for _ in range(STEPS):
            ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y))
            one.append({k: float(v) for k, v in m.items()})
    ranks.join()
    assert "logs" in outs, "the ranks did not finish"
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return want, got, (ts, one), md


def _metrics_match(got, want, tol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["conv", "lut"])
def test_tp_eval_matches_jax(tp_run, kind):
    want, got, _, _ = tp_run
    assert got[0][kind] == got[1][kind]
    _metrics_match(got[0][kind], want[kind], 1e-9)


def _trees(sd, md):
    model = md.init(device="cpu", dtype=torch.float64)
    model.load_state_dict(sd, strict=True)
    return jax_trees(model)


def test_tp_train_steps_match_jax(tp_run):
    want, got, _, md = tp_run
    wparams, wstate, wema, wmetrics = want["tp"]
    payload = got[0]["payload"]
    for a, b in zip(got[0]["train"], got[1]["train"]):
        assert a == b
    for g, w in zip(got[0]["train"], wmetrics):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-10)
        _metrics_match(g, w, 1e-9)
    params, state = _trees(payload["model"], md)
    assert_trees_match(params, wparams, rtol=1e-9, atol=1e-9)
    assert_trees_match(state, wstate, rtol=1e-9, atol=1e-9)
    ema_sd = {**payload["model"], **payload["opt_state"]["ema"]}
    ema, _ = _trees(ema_sd, md)
    assert_trees_match(ema, wema, rtol=1e-9, atol=1e-9)


def test_gathered_state_equals_the_one_process_step(tp_run):
    _, got, (ts, one), _ = tp_run
    p0, p1 = got[0]["payload"], got[1]["payload"]
    # every rank gathers the same whole state
    for part in ("model",):
        for k, v in p0[part].items():
            assert torch.equal(v, p1[part][k]), k
    assert p0["step"] == ts.step == STEPS
    whole = ts.model.state_dict()
    assert list(p0["model"]) == list(whole)
    for k, v in whole.items():
        torch.testing.assert_close(p0["model"][k], v, rtol=1e-9, atol=1e-9)
    for part, tensors in ts.opt_state.items():
        for k, v in tensors.items():
            torch.testing.assert_close(p0["opt_state"][part][k], v,
                                       rtol=1e-9, atol=1e-9)
    for g, w in zip(got[0]["train"], one):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-10)
    # the replicated leaves are bit-equal on the two ranks; the channel
    # slices are the two halves
    l0, l1 = got[0]["local"], got[1]["local"]
    head = [k for k in l0 if ".BN2." in k or ".lin2." in k]
    assert len(head) == 7
    for k in head:
        assert torch.equal(l0[k], l1[k]), k
    stem = "features.1.weight"
    assert torch.equal(torch.cat([l0[stem], l1[stem]]), p0["model"][stem])


def test_jax_tp_step_sums_over_data():
    """The collectives of JAX's TP step (``tp.py:87-105,344-350``) on a 2x2
    mesh: a row-parallel partial product summed over ``model``, a head
    weight replicated over both axes, its gradient ``pmean``'d over
    ``data``.  The mean of the two data shards' gradients is 1.5; the step
    takes their sum, 3.0 (queue C, beside the data-parallel steps')."""
    mesh = _mesh(2)

    def grad_pmean(w, v, x):
        def loss(w):
            y = jax.lax.psum(x * v, "model")      # the row-parallel sum
            return jnp.sum(w * y)
        return jax.lax.pmean(jax.grad(loss)(w), "data")

    f = jax.jit(jax.shard_map(grad_pmean, mesh=mesh,
                              in_specs=(P(), P("model"), P("data")),
                              out_specs=P()))
    # model shards of v: 0.5 each, so y = x on each data shard
    got = f(jnp.ones(()), jnp.array([0.5, 0.5]), jnp.array([1.0, 2.0]))
    assert float(got) == 3.0
