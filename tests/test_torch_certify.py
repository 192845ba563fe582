"""Certified eval (``--certify``) of the port against the JAX package on
the CPU.

The interval logits and the interval loss of the three models whose
registry entries carry the hooks (``cifar10lownoise``, ``model_general``
in its stem/head kinds, ``tt_certif`` with both heads) match JAX's in f64
to 1e-9 over a per-channel ball (pixel units through the ImageNet
normalization, as ``_pixel_ball`` maps it); the bounds are sound: the
concrete logits at points drawn in the ball (and, for ``tt_certif``, under
fresh coin flips) lie inside them; ``main --mode eval --certify`` through
both CLIs on the same weights and shards gives equal top-1, top-5 and
``cert``; a model without the hook is refused as JAX refuses it.
"""

import io
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, few_threads, x64  # noqa: F401
from test_torch_cifar_zoo import zoo_pair

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.train.steps import _pixel_ball as jpixel_ball
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
    IMAGENET_STD, write_shards
from scale_imagenet_tpu_torch.ops import NoiseKey
from scale_imagenet_tpu_torch.train.steps import _pixel_ball

TOL = dict(rtol=1e-9, atol=1e-9)
STATS = (IMAGENET_MEAN, IMAGENET_STD)

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

# (name, registry kwargs): the hooks' models, every head kind
HOOKED = [("cifar10lownoise", {}),
          ("model_general", {}),
          ("model_general", dict(type_weights_preprocessing="float",
                                 type_weights_final="float",
                                 use_scalar_scale_last_layer=False)),
          ("tt_certif", dict(nfilter=1, tfilter=3)),
          ("tt_certif", dict(nfilter=1, tfilter=3, head="binpos_v2"))]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(HOOKED)]


def _normalized(n: int, seed: int) -> np.ndarray:
    """``n`` 32x32 images in [0, 1], ImageNet-normalized (the shard
    route's input)."""
    u = np.random.default_rng(seed).uniform(size=(n, 32, 32, 3))
    return (u - IMAGENET_MEAN) / IMAGENET_STD


@pytest.mark.parametrize("name,kw", HOOKED, ids=IDS)
def test_interval_logits_and_loss_match_jax_f64(x64, name, kw):  # noqa: F811
    jm, params, state, md, model = zoo_pair(name, kw, seed=21)
    x = _normalized(2, 22)
    eps = 2 / 255
    ball = _pixel_ball(eps, STATS)
    for j, p in zip(jpixel_ball(eps, STATS), ball):
        # f32 on both sides (XLA's division may round an ulp apart)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=3e-7)
    # both sides take the port's ball, in f64
    jball = tuple(b.numpy().astype(np.float64) for b in ball)
    ball = tuple(torch.from_numpy(b) for b in jball)

    def fwd(p, s, a):
        return (jm.interval_logits(p, s, a, *jball),
                jm.interval_loss(p, s, a, *jball))

    iv, loss = jax.jit(fwd).lower(params, state, x).compile(_FAST_COMPILE)(
        params, state, x)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = md.interval_logits(model, xt, *ball)
        gloss = md.interval_loss(model, xt, *ball)
    np.testing.assert_allclose(got.vmin.numpy(), np.asarray(iv.vmin), **TOL)
    np.testing.assert_allclose(got.vmax.numpy(), np.asarray(iv.vmax), **TOL)
    np.testing.assert_allclose(float(got.loss), float(iv.loss), **TOL)
    np.testing.assert_allclose(float(gloss), float(loss), **TOL)
    assert bool((got.vmin <= got.vmax).all()) and float(gloss) > 0


@pytest.mark.parametrize("name,kw", HOOKED[::2], ids=IDS[::2])
def test_bounds_hold_at_points_in_the_ball(name, kw):
    """64 points a image drawn in the clipped ball (its corners among
    them): every concrete logit lies in the f64 bounds."""
    _, _, _, md, model = zoo_pair(name, kw, seed=23)
    x = torch.from_numpy(_normalized(4, 24))
    eps, lo, hi = (b.double() for b in _pixel_ball(8 / 255, STATS))
    g = torch.Generator().manual_seed(25)
    with torch.no_grad():
        iv = md.interval_logits(model, x, eps, lo, hi)
        for i in range(64):
            u = torch.rand(x.shape, generator=g, dtype=x.dtype) * 2 - 1
            if i < 2:
                u = torch.sign(u)        # corners
            pt = torch.minimum(torch.maximum(x + u * eps, lo), hi)
            kw_ = {"noise": NoiseKey(i)} if md.stochastic else {}
            y = model(pt, **kw_)
            assert bool((y >= iv.vmin - 1e-9).all()), (name, i)
            assert bool((y <= iv.vmax + 1e-9).all()), (name, i)


def _shards(model, tmp_path, n: int = 12) -> str:
    """Seeded 32x32 uint8 shards, labelled by ``model``'s own argmax (so
    that some images certify at a small radius)."""
    u8 = np.random.default_rng(26).integers(0, 256, (n, 32, 32, 3),
                                            dtype=np.uint8)
    x = torch.from_numpy((u8 / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    with torch.no_grad():
        labels = model(x.float()).argmax(-1).numpy().astype(np.int32)
    labels[::3] = (labels[::3] + 1) % 10       # some wrong
    path = str(tmp_path / "shards")
    write_shards(ArrayDataset(u8, labels), path)
    return path


@pytest.mark.parametrize("name", ["cifar10lownoise", "model_general"])
def test_cli_certify_matches_jax_cli(tmp_path, name):
    _, _, _, md, model = zoo_pair(name, {}, seed=27, dtype=np.float32)
    params, state = jax.tree.map(np.array, jax_trees(model))
    weights = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), weights)
    base = ["--mode", "eval", "--model", name, "--shards_dir",
            _shards(model, tmp_path), "--eval_batch_size", "5",
            "--certify", "0.0001", "--root_dir", str(tmp_path)]
    with redirect_stdout(io.StringIO()) as out:
        got = cli.main(base + ["--device", "cpu", "--ckpt", weights])
    assert "certified@eps=0.0001" in out.getvalue()
    with mock.patch.object(jmain, "load_params",
                           lambda cfg, m: (params, state)), \
            redirect_stdout(io.StringIO()):
        want = jmain.main(base + ["--mesh_data", "1"])
    top1, top5, _, extras = got
    assert (top1, top5) == tuple(want[:2])
    assert extras == want[2] and set(extras) == {"cert"}
    assert 0 < extras["cert"] <= top1


def test_certify_refused_without_the_hook(tmp_path):
    shards = str(tmp_path / "s")
    write_shards(ArrayDataset(np.zeros((2, 32, 32, 3), np.uint8),
                              np.zeros(2, np.int32)), shards)
    argv = ["--mode", "eval", "--model", "mobilenet_v1_tt", "--shards_dir",
            shards, "--certify", "0.01", "--model_arg", "n=1", "--model_arg",
            "t=2", "--root_dir", str(tmp_path)]
    with pytest.raises(ValueError) as got, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu"])
    # the JAX CLI with zero weights of the init's shapes (its op-by-op
    # init takes seconds)
    zeros = lambda cfg, m: jax.tree.map(  # noqa: E731
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(m.init, jax.random.PRNGKey(0)))
    with mock.patch.object(jmain, "load_params", zeros), \
            pytest.raises(ValueError) as want, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--mesh_data", "1"])
    assert str(got.value) == str(want.value)
    assert "no interval_logits hook" in str(got.value)
