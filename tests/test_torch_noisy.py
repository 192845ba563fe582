"""The port's dead-zone Heaviside, the Bi-Real surrogate and the noisy
``TT_FHE_small`` against the JAX package on the CPU.

The noisy core takes its coin flips as a tensor on both sides, so one
numpy draw feeds both: the forward and the hardtanh backward equal
exactly, the tanh backward to 1e-12 in f64 and two ulps in f32 (torch's
and XLA's tanh differ by an ulp in places).  The Bi-Real
surrogate's gradients (input, ``alpha``, ``beta``) match in f64 to 1e-12.
For whole models JAX draws its flips with ``jax.random.bernoulli``; the
test records them in call order (an ordered debug callback inside
``jit``) and the port's noise hook replays them (``_torch_port.Replay``),
each draw site checked by shape.
With the same flips ``TT_FHE_small``'s f64 logits match to 1e-9.
"""

import io
from contextlib import redirect_stdout
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import Replay, images, jax_and_port, jax_cli_refusal, \
    recorded_bernoulli, x64  # noqa: F401

from scale_imagenet_tpu import config as jconfig
from scale_imagenet_tpu.ops import binarize as jb
from scale_imagenet_tpu_torch import config as tconfig
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.models import block_tt, get_model
from scale_imagenet_tpu_torch.models.block_tt import BlockTT, \
    BlockTTConfig, takes_fused_kernel
from scale_imagenet_tpu_torch.ops import NoiseKey, binarize01_act, \
    bireal_act, dead_zone_noise, heaviside01_noisy

SMALL = "TT_FHE_small"
W = dict(nfilter=2, tfilter=2)


@pytest.fixture(params=[1.0, None], ids=["tanh", "hardtanh"])
def surrogate(request):
    """Both STE surrogates, set in both packages."""
    saved = (jconfig.numerics.bingrad_soft_tanh_scale,
             tconfig.numerics.bingrad_soft_tanh_scale)
    jconfig.numerics.bingrad_soft_tanh_scale = request.param
    tconfig.numerics.bingrad_soft_tanh_scale = request.param
    try:
        yield request.param
    finally:
        (jconfig.numerics.bingrad_soft_tanh_scale,
         tconfig.numerics.bingrad_soft_tanh_scale) = saved


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_noisy_core_matches_jax(x64, surrogate, dtype):  # noqa: F811
    T = 0.1
    rng = np.random.default_rng(1)
    # values on and around the dead zone's edges
    x = np.concatenate([rng.uniform(-0.2, 0.2, 400),
                        [T / 2, -T / 2, 0.0, np.nextafter(T / 2, 0)]])
    x = x.astype(dtype)
    noise = rng.integers(0, 2, x.shape).astype(dtype)
    g = rng.standard_normal(x.shape).astype(dtype)
    half = jnp.asarray(T / 2, dtype)
    one = jnp.asarray(1.0, dtype)
    want, vjp = jax.vjp(
        lambda a: jb._heaviside01_noisy_core(a, jnp.asarray(noise), half,
                                             one), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    got = heaviside01_noisy(xt, T, torch.from_numpy(noise))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    if surrogate is None:
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    else:
        # torch's and XLA's tanh differ by an ulp of the dtype in places
        rtol = 1e-12 if dtype == np.float64 else 2 * np.finfo(dtype).eps
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                                   rtol=rtol, atol=0)
    # the same function outside autograd
    np.testing.assert_array_equal(
        heaviside01_noisy(torch.from_numpy(x), T,
                          torch.from_numpy(noise)).numpy(), np.asarray(want))


def test_bireal_surrogate_matches_jax_f64(x64):  # noqa: F811
    rng = np.random.default_rng(2)
    x = rng.uniform(-3, 3, (4, 3, 5, 5))
    g = rng.standard_normal(x.shape)
    alpha, beta = 1.3, -0.2
    want, vjp = jax.vjp(jb.bireal_act, jnp.asarray(x), jnp.asarray(alpha),
                        jnp.asarray(beta))
    wx, wa, wb = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    bt = torch.tensor(beta, dtype=torch.float64, requires_grad=True)
    got = bireal_act(xt, at, bt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for t, w in ((xt, wx), (at, wa), (bt, wb)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-12, atol=1e-12)
    assert float(at.grad) != 0.0 and float(bt.grad) != 0.0


def test_draws_are_keyed_and_refused_without_a_key():
    x = torch.zeros((64, 64))
    a = NoiseKey(7).child(1).draw(x)
    assert torch.equal(a, NoiseKey(7).child(1).draw(x))
    assert not torch.equal(a, NoiseKey(7).child(2).draw(x))
    assert not torch.equal(a, NoiseKey(8).child(1).draw(x))
    assert set(a.unique().tolist()) == {0.0, 1.0}
    assert abs(float(a.mean()) - 0.5) < 0.05
    gen = torch.Generator().manual_seed(3)
    b = dead_zone_noise(x.double(), gen)
    assert b.dtype == torch.float64 and b.shape == x.shape
    with pytest.raises(ValueError, match="T != 0 needs a noise key"):
        binarize01_act(x, T=0.1)
    # T = 0 draws nothing
    assert torch.equal(binarize01_act(x - 1, T=0.0, noise=None),
                       torch.zeros_like(x))


def _count_fused():
    calls = []
    real = block_tt.fused_pointwise_nchw

    def rec(*a, **k):
        calls.append(1)
        return real(*a, **k)
    return calls, mock.patch.object(block_tt, "fused_pointwise_nchw", rec)


def test_fused_gate_takes_only_deterministic_float_blocks(monkeypatch):
    """With the switch on, a k=1 block with ``T != 0`` (or a BinConv2d
    first conv) never reaches the fused kernel; a ``T == 0`` float block
    does, and no training forward does."""
    monkeypatch.setattr(tconfig.performance, "fused_pointwise_blocks", True)
    base = dict(in_planes=8, out_planes=8, k=1, t=2, padding=0,
                groupsici=2)
    assert takes_fused_kernel(BlockTTConfig(**base), training=False)
    assert not takes_fused_kernel(BlockTTConfig(**base), training=True)
    assert not takes_fused_kernel(BlockTTConfig(**base, T=0.1), False)
    assert not takes_fused_kernel(BlockTTConfig(**base, quant="bin"), False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BlockTT(BlockTTConfig(**base, quant="bin"))
    x = torch.rand((2, 8, 5, 5)).round()
    calls, patch = _count_fused()
    with patch, torch.no_grad():
        BlockTT(BlockTTConfig(**base, T=0.1)).eval()(
            x, noise=NoiseKey(0))
        assert not calls
        BlockTT(BlockTTConfig(**base)).eval()(x)
        assert len(calls) == 1
    # whole models: TT_FHE_small's blocks never, TT_FHE_SMALL's two k=1
    # heads a forward
    for name, want in ((SMALL, 0), ("TT_FHE_SMALL", 2)):
        model = get_model(name, **W).init(device="cpu")
        calls, patch = _count_fused()
        with patch, torch.no_grad():
            out = model(torch.rand((2, 32, 32, 3)), noise=NoiseKey(1))
        assert len(calls) == want and out.shape == (2, 10), name


def test_tt_fhe_small_matches_jax_f64_with_replayed_noise(x64):  # noqa: F811
    jm, params, state, md, model = jax_and_port(SMALL, np.float64, seed=4,
                                                **W)
    assert md.stochastic and md.name == jm.name == SMALL
    assert md.config.fcsize == jm.config.fcsize
    x = images((3, 32, 32, 3), 5) * 2 - 1
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    # under jit: XLA's op-by-op f64 execution of this model corrupts the
    # heap on this CPU build now and then
    fwd = jax.jit(lambda p, s, a, k: jm.apply(p, s, a, training=False,
                                              key=k)[0])
    with recorded_bernoulli() as draws:
        ref = fwd(jp, js, jnp.asarray(x), jax.random.PRNGKey(9))
    # the stem, heads 1-3 and the fuse head: one draw each
    assert len(draws) == 5
    replay = Replay(draws)
    with torch.no_grad():
        got = model(torch.from_numpy(x), noise=replay)
    assert replay.used == len(draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-9)
    # the noise acts: other flips, other logits
    with torch.no_grad():
        other = model(torch.from_numpy(x), noise=NoiseKey(0))
        again = model(torch.from_numpy(x), noise=NoiseKey(0))
    assert torch.equal(other, again)
    assert not torch.equal(other, got)
    with pytest.raises(ValueError, match="T != 0 needs a noise key"):
        model(torch.from_numpy(x))


def _jax_refusal(argv, tmp_path) -> str:
    err = jax_cli_refusal(argv, str(tmp_path))
    assert isinstance(err, ValueError), err
    return str(err)


@pytest.mark.parametrize("argv", [
    ["--mode", "eval", "--lut"], ["--mode", "eval", "--gates", "dnf"],
    ["--mode", "serve", "--lut"], ["--mode", "serve", "--gates", "cnf"],
    ["--mode", "eval", "--fold_bn"],
    ["--mode", "train", "--remat"],
], ids=["eval_lut", "eval_gates", "serve_lut", "serve_gates",
        "eval_fold_bn", "train_remat"])
def test_tt_fhe_small_refusals_are_the_jax_messages(argv, tmp_path):
    """No table or circuit represents the dead zone: ``--lut`` and
    ``--gates`` refuse with the JAX package's text, as do ``--fold_bn``
    and ``--remat`` (families)."""
    argv = argv + ["--model", SMALL, "--nfilter", "2", "--tfilter", "2",
                   "--shards_dir", str(tmp_path)]
    if argv[1] == "serve":
        argv = argv[:-2]
    want = _jax_refusal(argv, tmp_path)
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu", "--root_dir", str(tmp_path)])
    assert str(err.value) == want


def test_tt_fhe_small_compile_and_export_as_jax(tmp_path):
    """``--mode compile`` ends where the JAX CLI's does (its first noisy
    head needs a key), and ``--mode export`` writes ``export_tt_fhe``'s
    keys and values (the plain classifier's biases, no second BN)."""
    from scale_imagenet_tpu.convert.torch_export import export_tt_fhe
    from scale_imagenet_tpu_torch.convert import jax_trees

    argv = ["--mode", "compile", "--model", SMALL, "--nfilter", "2",
            "--tfilter", "2", "--compile_out", str(tmp_path / "c")]
    want = _jax_refusal(argv, tmp_path)
    assert "T != 0 needs a" in want
    with pytest.raises(ValueError, match="T != 0 needs a noise key"), \
            redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu"])
    path = str(tmp_path / "e.pth")
    with redirect_stdout(io.StringIO()):
        cli.main(["--mode", "export", "--model", SMALL, "--nfilter", "2",
                  "--tfilter", "2", "--export_out", path, "--device", "cpu"])
    sd = torch.load(path, weights_only=True)["model_state_dict"]
    model = get_model(SMALL, **W).init(device="cpu")
    params, state = jax_trees(model)
    want = export_tt_fhe(params, state, model.cfg)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy().reshape(np.shape(v)),
                                      np.asarray(v), err_msg=k)
    assert "features.8.bias" in sd and "features.9.weight" not in sd
