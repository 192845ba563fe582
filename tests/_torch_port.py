"""Shared helpers for the PyTorch port's tests (``tests/test_torch_*.py``).

Inputs and noise come from numpy with fixed seeds and go to both sides; the
JAX package is the reference.  JAX float paths run in f64 under the ``x64``
fixture, the Pallas gather in interpret mode.
"""

import contextlib
import os
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for a module's torch work: with several pytest
    workers on one machine, torch's default of one thread a core
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def tree_np(tree, dtype=None):
    """A JAX tree as nested dicts of numpy arrays (optionally cast)."""
    return jax.tree.map(
        lambda a: np.asarray(a, dtype) if dtype else np.asarray(a), tree)


def perturb_state(state, seed: int, scale: float = 0.05):
    """Seeded noise on BN running statistics (1-D leaves), so truth tables
    and Heaviside outputs are not the trivial ones of a fresh init."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(a.shape).astype(a.dtype) * scale
        return a * np.exp(noise) if "running_var" in name else a + noise
    return jax.tree_util.tree_map_with_path(f, state)


def jax_and_port(name: str, dtype, seed: int = 0, jit: bool = False, **kw):
    """One JAX init feeding both sides: ``(jax_model, params, state,
    port_model_def, port_model)`` with params/state as numpy trees in
    ``dtype`` and the port model on the CPU holding the same values.
    ``jit`` compiles the init as one program (the same values; faster than
    the op-by-op init for a small model)."""
    from scale_imagenet_tpu.models import get_model as jget
    from scale_imagenet_tpu_torch.convert import state_dict_from_jax
    from scale_imagenet_tpu_torch.models import get_model

    jm = jget(name, **kw)
    init = jax.jit(jm.init) if jit else jm.init
    params, state = init(jax.random.PRNGKey(seed))
    params = tree_np(params, dtype)
    state = perturb_state(tree_np(state, dtype), seed + 100)
    md = get_model(name, **kw)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = md.init(device="cpu", dtype=tdtype)
    model.load_state_dict(state_dict_from_jax(params, state, md.config),
                          strict=True)
    return jm, params, state, md, model


def port_and_trees(name: str, dtype=np.float64, seed: int = 0, **kw):
    """The port's seeded model (BN statistics perturbed) and its values as
    the JAX package's trees: ``(jax_model, params, state, port_model_def,
    port_model)``, as ``jax_and_port`` returns them.  No JAX init runs (its
    compile is most of a small model's time); ``convert/from_jax.py``'s
    inverse map carries the values."""
    from scale_imagenet_tpu.models import get_model as jget
    from scale_imagenet_tpu_torch.convert import jax_trees
    from scale_imagenet_tpu_torch.models import get_model

    md = get_model(name, **kw)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = md.init(seed=seed, device="cpu", dtype=tdtype)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.running_mean.shape
                m.running_mean.add_(0.05 * torch.randn(n, generator=gen).to(
                    m.running_mean))
                m.running_var.mul_(torch.exp(0.05 * torch.randn(
                    n, generator=gen)).to(m.running_var))
    # copies: the trees would otherwise share the model's memory
    params, state = jax.tree.map(np.array, jax_trees(model))
    return jget(name, **kw), params, state, md, model


def block_from_jax(kw: dict, seed: int, dtype=np.float64):
    """One JAX ``init_block_tt`` (BN statistics perturbed) and the port's
    ``BlockTT`` holding the same weights through ``convert/from_jax.py``:
    ``(params, state, block)``, numpy trees and the module in ``dtype``."""
    from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JCfg, \
        init_block_tt
    from scale_imagenet_tpu_torch.convert.from_jax import _bn, _conv
    from scale_imagenet_tpu_torch.models.block_tt import BlockTT, \
        BlockTTConfig

    p, s = init_block_tt(jax.random.PRNGKey(seed), JCfg(**kw))
    p = tree_np(p, dtype)
    s = perturb_state(tree_np(s, dtype), seed, scale=0.2)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    block = BlockTT(BlockTTConfig(**kw)).to(tdtype).eval()
    sd = {"conv1.weight": _conv(p["conv1"]["weight"]),
          "conv2.weight": _conv(p["conv2"]["weight"]),
          "act.grad_scale": torch.tensor(1.0)}
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    _bn(sd, "bn2", p["bn2"], s["bn2"])
    block.load_state_dict(sd, strict=True)
    return p, s, block


def images(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape)


def nchw(x: torch.Tensor) -> np.ndarray:
    """Port NCHW tensor -> numpy NHWC (the JAX layout)."""
    return x.permute(0, 2, 3, 1).detach().numpy()


# the train-step parity tests compare values, not speed: a lower XLA
# optimisation level shortens the compile, which is most of their time
_FAST_COMPILE = {"xla_backend_optimization_level": 1,
                 "xla_llvm_disable_expensive_passes": True}


def jax_train_steps(jm, tx, params, state, batches, compile_options=None,
                    keys=None, **kw):
    """Run the JAX package's ``make_train_step(jm, tx, **kw)`` (compiled
    once, with ``compile_options`` added to XLA's) over ``batches``
    (``(images, labels)`` numpy pairs) from ``(params, state)``.  Returns
    ``(params, state, metrics, ema)``: numpy trees, one ``{"loss", "top1",
    "top5"}`` dict of floats a step, and the EMA params tree (None without
    ``params_ema`` in ``tx``).  ``keys``: one PRNG key a step, for models
    whose forward draws (None: no key)."""
    import jax.numpy as jnp

    from scale_imagenet_tpu.train import TrainState, make_train_step
    from scale_imagenet_tpu.train.optim import get_ema

    p = jax.tree.map(jnp.array, params)
    ts = TrainState(p, jax.tree.map(jnp.array, state), tx.init(p),
                    jnp.zeros((), jnp.int32))
    step = make_train_step(jm, tx, **kw)
    keys = keys or [None] * len(batches)
    compiled = step.lower(ts, *batches[0], keys[0]).compile(
        {**_FAST_COMPILE, **(compile_options or {})})
    metrics = []
    for (x, y), key in zip(batches, keys):
        ts, m = compiled(ts, x, y, key)
        metrics.append({k: float(v) for k, v in m.items()})
    ema = get_ema(ts.opt_state)
    return (tree_np(ts.params), tree_np(ts.model_state), metrics,
            None if ema is None else tree_np(ema))


def site_disagreements(jm, params, state, x, model, jax_site, port_site,
                       side) -> list:
    """One training-mode forward of the JAX model (under ``jit``) and of
    the port's on the same weights and batch ``x``, the inputs of every
    call of one kind of site recorded in call order: ``jax_site`` and
    ``port_site`` are ``(object, attribute)`` of that site's function in
    each package (a ReLU, a Heaviside).  Returns, a site, the count of
    entries that ``side`` (e.g. ``lambda a: a > 0``, the ReLU's gradient
    mask) puts on different sides in the two frameworks, and the largest
    ``|port input|`` among them (0 where the port's input is an exact
    zero: a tie that the two frameworks' reductions round apart)."""
    jax_in, port_in = [], []
    jreal = getattr(*jax_site)
    preal = getattr(*port_site)

    def fwd(p, s, a):
        got = []

        def spy(h, *q, **k):
            got.append(h)
            return jreal(h, *q, **k)

        with mock.patch.object(*jax_site, spy):
            out, _ = jm.apply(p, s, a, training=True)
        return out, got

    def pspy(h, *q, **k):
        port_in.append(h.detach())
        return preal(h, *q, **k)

    _, jax_in = jax.jit(fwd).lower(params, state, x).compile(
        _FAST_COMPILE)(params, state, x)
    with mock.patch.object(*port_site, pspy), torch.no_grad():
        model(torch.from_numpy(x), {})
    assert len(jax_in) == len(port_in)
    sites = []
    for j, h in zip(jax_in, port_in):
        h = nchw(h) if h.dim() == 4 else h.numpy()
        apart = side(h) != side(np.asarray(j))
        sites.append((int(apart.sum()),
                      float(np.abs(h[apart]).max()) if apart.any() else None))
    return sites


@contextlib.contextmanager
def recorded_bernoulli():
    """Record every ``jax.random.bernoulli`` output, in call order, as
    numpy arrays (the JAX package's dead-zone coin flips): at once outside
    ``jit``, through an ordered debug callback at run time inside it."""
    draws = []
    real = jax.random.bernoulli

    def rec(*a, **k):
        out = real(*a, **k)
        if isinstance(out, jax.core.Tracer):
            jax.debug.callback(lambda v: draws.append(np.asarray(v)), out,
                               ordered=True)
        else:
            draws.append(np.asarray(out))
        return out

    with mock.patch.object(jax.random, "bernoulli", rec):
        yield draws
        jax.effects_barrier()


class Replay:
    """A port noise key that hands out recorded JAX coin flips in call
    order instead of drawing: every child is the same replay.  Each draw
    site must ask for the shape JAX drew at the same place (NHWC there,
    NCHW here)."""

    def __init__(self, draws: list):
        self.draws = list(draws)
        self.used = 0

    def child(self, index) -> "Replay":
        return self

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        want = self.draws[self.used]
        got = (x.shape[0], *x.shape[2:], x.shape[1]) if x.dim() == 4 \
            else tuple(x.shape)
        assert want.shape == got, (self.used, want.shape, got)
        self.used += 1
        a = np.moveaxis(want, -1, 1) if x.dim() == 4 else want
        return torch.from_numpy(np.ascontiguousarray(a)).to(x)


_REFUSALS: dict = {}


def jax_cli_refusal(argv: list, root: str) -> BaseException:
    """The exception the JAX CLI raises for ``argv`` (memoized).  An eval
    refusal is taken from ``--mode serve``: the same function raises the
    same text there, without the eval loop's set-up (its TensorBoard
    writer and loader), which costs the tests seconds a call."""
    import io
    from contextlib import redirect_stdout

    from scale_imagenet_tpu import main as jmain

    if argv[:2] == ["--mode", "eval"]:
        argv = ["--mode", "serve"] + [
            a for i, a in enumerate(argv[2:], 2)
            if a != "--shards_dir" and argv[i - 1] != "--shards_dir"]
    key = tuple(argv)
    if key not in _REFUSALS:
        with pytest.raises(Exception) as err, \
                redirect_stdout(io.StringIO()):
            jmain.main(argv + ["--root_dir", root, "--mesh_data", "1"])
        _REFUSALS[key] = err.value
    return _REFUSALS[key]


ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv_for, world: int = 2, env_for=None,
                 timeout: float = 240) -> list:
    """Start ``world`` Python processes (``argv_for(rank)`` after the
    interpreter; ``env_for(rank)`` added to the environment), one thread
    of torch each, and wait for all: their outputs, each process's
    return code checked.  A process past ``timeout`` seconds (a rank
    waiting forever on a collective) is killed, and so are the others."""
    procs = []
    try:
        for rank in range(world):
            env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   "OMP_NUM_THREADS": "1",
                   **(env_for(rank) if env_for else {})}
            procs.append(subprocess.Popen(
                [sys.executable, *argv_for(rank)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs
