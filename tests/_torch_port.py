"""Shared helpers for the PyTorch port's tests (``tests/test_torch_*.py``).

Inputs and noise come from numpy with fixed seeds and go to both sides; the
JAX package is the reference.  JAX float paths run in f64 under the ``x64``
fixture, the Pallas gather in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch


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


def jax_and_port(name: str, dtype, seed: int = 0, **kw):
    """One JAX init feeding both sides: ``(jax_model, params, state,
    port_model_def, port_model)`` with params/state as numpy trees in
    ``dtype`` and the port model on the CPU holding the same values."""
    from scale_imagenet_tpu.models import get_model as jget
    from scale_imagenet_tpu_torch.convert import state_dict_from_jax
    from scale_imagenet_tpu_torch.models import get_model

    jm = jget(name, **kw)
    params, state = jm.init(jax.random.PRNGKey(seed))
    params = tree_np(params, dtype)
    state = perturb_state(tree_np(state, dtype), seed + 100)
    md = get_model(name, **kw)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = md.init(device="cpu", dtype=tdtype)
    model.load_state_dict(state_dict_from_jax(params, state, md.config),
                          strict=True)
    return jm, params, state, md, model


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
