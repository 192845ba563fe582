"""The port's ``robust/`` (``scale_imagenet_tpu_torch/robust/``) against the
JAX package's on the CPU.

Every interval transformer, ``rsloss``, the multi-sample pack (its signs
drawn by JAX and replayed into the port), ``multi_sample_heaviside``, the
collector's ``multi_sample_forward`` (logits, stability loss and BN
statistics), the bias regulariser and ``fanin_nonzero`` match JAX's in f64
to 1e-12, masks and Heaviside bits exactly.  The activation observer sees
the same Heaviside sites as JAX's, in JAX's order, with the same loss at
each, on every family tested (the flagship at a small width included);
the BN observer sees the same ``(scale, bias)`` pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import Replay, _FAST_COMPILE, block_from_jax, few_threads, \
    images, nchw, port_and_trees, recorded_bernoulli, x64  # noqa: F401
from test_torch_cifar_zoo import zoo_pair

from scale_imagenet_tpu import robust as jrobust
from scale_imagenet_tpu.layers import norm as jnorm
from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg
from scale_imagenet_tpu.ops.binarize import rsloss as jrsloss
from scale_imagenet_tpu.robust import interval as jiv
from scale_imagenet_tpu_torch import robust
from scale_imagenet_tpu_torch.ops.binarize import rsloss
from scale_imagenet_tpu_torch.robust import interval as piv

TOL = dict(rtol=1e-12, atol=1e-12)

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nhwc_pair(shape, seed: int, spread: float = 0.3):
    """An NHWC ``(vmin, vmax)`` pair, ``vmin <= vmax``."""
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal(shape)
    return lo, lo + spread * rng.uniform(size=shape)


def _jiv(lo, hi):
    return jiv.Interval(jnp.asarray(lo), jnp.asarray(hi),
                        jnp.zeros((), jnp.float64))


def _piv(lo, hi):
    """The port's interval of an NHWC pair, NCHW (or 2-D as it is)."""
    lo, hi = _t(lo), _t(hi)
    if lo.dim() == 4:
        lo, hi = lo.permute(0, 3, 1, 2), hi.permute(0, 3, 1, 2)
    return piv.Interval(lo, hi, torch.zeros((), dtype=torch.float64))


def assert_iv(got, want, exact: bool = False) -> None:
    for g, w in ((got.vmin, want.vmin), (got.vmax, want.vmax)):
        g = nchw(g) if g.dim() == 4 else g.detach().numpy()
        if exact:
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
    np.testing.assert_allclose(float(got.loss.detach()), float(want.loss),
                               **TOL)


def test_rsloss_eps_ball_and_gelu_constants(x64):  # noqa: F811
    lo, hi = _nhwc_pair((2, 5, 5, 3), 0)
    np.testing.assert_allclose(float(rsloss(_t(lo), _t(hi))),
                               float(jrsloss(lo, hi)), **TOL)
    x = images((2, 6, 6, 3), 1)
    eps = np.array([0.01, 0.02, 0.03])
    lo_c, hi_c = np.array([-0.1, 0.0, 0.05]), np.array([1.0, 0.9, 1.1])
    got = piv.interval_from_eps_ball(_t(x), _t(eps), _t(lo_c), _t(hi_c))
    want = jiv.interval_from_eps_ball(x, eps, lo_c, hi_c)
    for g, w in ((got.vmin, want.vmin), (got.vmax, want.vmax)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (piv.GELU_XMIN, piv.GELU_MIN) == (jiv.GELU_XMIN, jiv.GELU_MIN)


def test_interval_layers_match_jax_f64(x64):  # noqa: F811
    rng = np.random.default_rng(2)
    lo, hi = _nhwc_pair((2, 7, 7, 4), 3)
    # a grouped, strided, padded conv (HWIO there, OIHW here)
    w = rng.standard_normal((3, 3, 2, 6))
    got = piv.interval_conv2d(_piv(lo, hi), _t(w.transpose(3, 2, 0, 1)),
                              stride=2, padding=1, groups=2)
    want = jiv.interval_conv2d(_jiv(lo, hi), w, stride=2, padding=1,
                               groups=2)
    assert_iv(got, want)
    # BN with negative scales swaps the bounds
    scale, bias = rng.standard_normal(4), rng.standard_normal(4)
    assert_iv(piv.interval_batch_norm(_piv(lo, hi), _t(scale), _t(bias)),
              jiv.interval_batch_norm(_jiv(lo, hi), scale, bias))
    # monotone maps, pooling, flattening, Heaviside (exact bits), GELU
    # (intervals straddling its minimum) and the dead zone
    assert_iv(piv.interval_mono(_piv(lo, hi), torch.relu),
              jiv.interval_mono(_jiv(lo, hi), jax.nn.relu), exact=True)
    assert_iv(piv.interval_avg_pool(_piv(lo, hi), 2),
              jiv.interval_avg_pool(_jiv(lo, hi), 2))
    assert_iv(piv.interval_heaviside(_piv(lo, hi)),
              jiv.interval_heaviside(_jiv(lo, hi)), exact=True)
    glo = np.linspace(-3, 1, 2 * 7 * 7 * 4).reshape(lo.shape)
    got = piv.interval_gelu(_piv(glo, glo + 0.5))
    want = jiv.interval_gelu(_jiv(glo, glo + 0.5))
    assert (np.asarray(want.vmin) == jiv.GELU_MIN).any()
    assert_iv(got, want)
    for T in (0.0, 0.16):
        assert_iv(piv.interval_heaviside_noisy(_piv(lo, hi), T),
                  jiv.interval_heaviside_noisy(_jiv(lo, hi), T), exact=True)
    flat = piv.interval_flatten(_piv(lo, hi))
    jflat = jiv.interval_flatten(_jiv(lo, hi))
    np.testing.assert_array_equal(flat.vmin.numpy(), np.asarray(jflat.vmin))
    # dense: a float Linear with bias ((in, out) there, (out, in) here) and
    # the BinLinearPos head with its NOT-gate bias
    v_lo, v_hi = _nhwc_pair((3, 10), 4)
    wl, bl = rng.standard_normal((10, 5)), rng.standard_normal(5)
    assert_iv(piv.interval_linear(_piv(v_lo, v_hi), _t(wl.T),
                                  torch.nn.functional.linear, bias=_t(bl)),
              jiv.interval_linear(_jiv(v_lo, v_hi), wl, lambda v, m: v @ m,
                                  bias=bl))
    wb = rng.integers(-1, 2, (10, 5)).astype(np.float64)
    assert_iv(piv.interval_bin_linear_pos(_piv(v_lo, v_hi), _t(wb.T)),
              jiv.interval_bin_linear_pos(_jiv(v_lo, v_hi), wb))
    assert_iv(piv.interval_struct(_piv(lo, hi), lambda v: v[:, :, :-1, :-1]),
              jiv.interval_struct(_jiv(lo, hi), lambda v: v[:, :-1, :-1, :]),
              exact=True)


@pytest.mark.parametrize("kw", [
    dict(in_planes=4, out_planes=4, k=3, padding=2, groupsici=4, T=0.16),
    dict(in_planes=4, out_planes=6, k=2, padding=1, stride=2, groupsici=2),
    dict(in_planes=4, out_planes=4, k=1, padding=0, groupsici=2, last=True)])
def test_interval_block_tt_matches_jax_f64(x64, kw):  # noqa: F811
    p, s, block = block_from_jax(kw, seed=5)
    lo, hi = _nhwc_pair((2, 9, 9, 4), 6, spread=0.05)
    got = piv.interval_block_tt(block, _piv(lo, hi))
    f = jax.jit(lambda p_, s_, a, b: jiv.interval_block_tt(
        p_, s_, JBlockCfg(**kw), _jiv(a, b)))
    want = f.lower(p, s, lo, hi).compile(_FAST_COMPILE)(p, s, lo, hi)
    assert_iv(got, want)


def test_certified_mask_matches_jax(x64):  # noqa: F811
    lo, hi = _nhwc_pair((64, 10), 7, spread=0.4)
    hi[::3] = lo[::3]      # point intervals: some certify
    preds = np.argmax(lo, -1)
    got = piv.certified_mask(_piv(lo, hi), _t(preds))
    want = np.asarray(jiv.certified_mask(_jiv(lo, hi), jnp.asarray(preds)))
    assert 0 < want.sum() < 64
    np.testing.assert_array_equal(got.numpy(), want)


class _Signs:
    """A port key that hands out JAX's recorded sign pattern."""

    def __init__(self, signs):
        self.signs = signs

    def child(self, index):
        return self

    def draw(self, x):
        return _t(self.signs).to(x)


def test_multi_sample_pack_heaviside_unpack(x64):  # noqa: F811
    x, x_adv = images((3, 4, 4, 3), 8), images((3, 4, 4, 3), 9)
    key = jax.random.PRNGKey(3)
    signs = np.asarray(jax.random.randint(key, x.shape, 0, 2)).astype(
        np.float64)
    lo, hi = np.array([0.1, 0.0, 0.2]), np.array([0.9, 1.0, 0.8])
    k, want = jrobust.multi_sample_pack(x, x_adv, 0.05, key, lo, hi)
    pk, got = robust.multi_sample_pack(_t(x), _t(x_adv), 0.05, _Signs(signs),
                                       _t(lo), _t(hi))
    assert k == pk == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    h = np.asarray(want) - 0.5
    out, loss = jrobust.multi_sample_heaviside(h, 3, jnp.asarray(0.25))
    pout, ploss = robust.multi_sample_heaviside(_t(h), 3, torch.tensor(0.25))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(out))
    np.testing.assert_allclose(float(ploss), float(loss), **TOL)
    np.testing.assert_array_equal(
        robust.multi_sample_unpack_natural(_t(h), 3).numpy(),
        np.asarray(jrobust.multi_sample_unpack_natural(h, 3)))


def test_bias_regularizer_and_fanin(x64):  # noqa: F811
    rng = np.random.default_rng(10)
    pairs = [(rng.uniform(0.1, 2, 1), rng.standard_normal(10) * 8),
             (rng.uniform(-2, 2, 6), rng.standard_normal(6) * 8)]
    fan = [rng.integers(1, 9, 10).astype(np.float64), None]
    for kw in (dict(), dict(layer_coeffs=[0.5, 0.0]),
               dict(fanin_weights=fan)):
        jkw = {k: [None if a is None else jnp.asarray(a) for a in v]
               if k == "fanin_weights" else v for k, v in kw.items()}
        pkw = {k: [None if a is None else _t(a) for a in v]
               if k == "fanin_weights" else v for k, v in kw.items()}
        want = jrobust.bias_regularizer_loss(
            [(jnp.asarray(s), jnp.asarray(b)) for s, b in pairs], 1e-3, 2.0,
            **jkw)
        got = robust.bias_regularizer_loss(
            [(_t(s), _t(b)) for s, b in pairs], 1e-3, 2.0, **pkw)
        assert float(want) > 0
        np.testing.assert_allclose(float(got), float(want), **TOL)
    w = rng.integers(-1, 2, (3, 3, 4, 6)).astype(np.float64)   # HWIO
    np.testing.assert_array_equal(
        robust.fanin_nonzero(_t(w.transpose(3, 2, 0, 1))).numpy(),
        np.asarray(jrobust.fanin_nonzero(w)))
    wl = rng.integers(-1, 2, (10, 5)).astype(np.float64)       # (in, out)
    np.testing.assert_array_equal(robust.fanin_nonzero(_t(wl.T)).numpy(),
                                  np.asarray(jrobust.fanin_nonzero(wl)))


def _jax_losses(jm, p, s, a, k):
    with jrobust.stability_loss_collector(3) as c:
        jm.apply(p, s, a, training=False, key=k)
    return c.losses


# (name, registry kwargs, image size): a family each, the flagship at a
# small width first
OBSERVED = [
    ("ttnet_imagenet_small", dict(nfilter=2, tfilter=2, layers=1,
                                  image_size=64), 64),
    ("TT_FHE_SMALL", dict(nfilter=2, tfilter=2), 32),
    ("TT_vf_19lv2_cifar", dict(nfilter=2, tfilter=2, a_bit=1), 32),
    ("TT_general", dict(nfilter=2, tfilter=2, a_bit=1, image_size=32), 32),
    ("mobilenet_v1_tt", dict(n=2, t=2), 32),
    ("model_general", {}, 32),
    ("cifar10lownoise", {}, 32),
    ("tt_certif", dict(nfilter=1, tfilter=3), 32),
]


@pytest.mark.parametrize("name,kw,size", OBSERVED,
                         ids=[n for n, _, _ in OBSERVED])
def test_observer_sees_jax_sites(x64, name, kw, size):  # noqa: F811
    """One eval forward of a packed batch (``k = 3``) on each side: the
    observers' losses, site by site (a stochastic model's coin flips
    recorded in JAX and replayed)."""
    jm, params, state, md, model = zoo_pair(name, kw, seed=11)
    x = images((6, size, size, 3), 12)
    key = jax.random.PRNGKey(5) if md.stochastic else None
    with recorded_bernoulli() as draws:
        want = jax.jit(lambda p, s, a, k: _jax_losses(jm, p, s, a, k)).lower(
            params, state, x, key).compile(_FAST_COMPILE)(params, state, x,
                                                          key)
    replay = Replay(draws)
    with robust.stability_loss_collector(3) as c, torch.no_grad():
        model(_t(x), **({"noise": replay} if md.stochastic else {}))
    assert replay.used == len(draws)
    assert len(want) > 0
    assert len(c.losses) == len(want)
    np.testing.assert_allclose([float(g) for g in c.losses],
                               [float(w) for w in want], rtol=1e-12,
                               atol=1e-9)


def test_collector_ignores_unpacked_batches():
    from scale_imagenet_tpu_torch.ops import binarize01_act

    with robust.stability_loss_collector(3) as c:
        binarize01_act(torch.zeros(4, 2))
        binarize01_act(torch.zeros(6, 2))
    assert len(c.losses) == 1
    # the last two of three groups of two rows, two entries a row
    assert float(c.total()) == pytest.approx(4 * (1 - np.tanh(1.0)))


@pytest.mark.parametrize("name", ["cifar10lownoise", "tt_certif"])
def test_multi_sample_forward_matches_jax_f64(x64, name):  # noqa: F811
    kw = dict(nfilter=1, tfilter=3) if name == "tt_certif" else {}
    jm, params, state, md, model = zoo_pair(name, kw, seed=13)
    x = images((3, 32, 32, 3), 14)
    key = jax.random.PRNGKey(7)
    pack_key, _ = jax.random.split(key)
    signs = np.asarray(jax.random.randint(pack_key, x.shape, 0, 2))

    def fwd(p, s, a, k):
        return jrobust.multi_sample_forward(jm, p, s, a, a, 0.03, k,
                                            return_state=True)

    with recorded_bernoulli() as draws:
        logits, sloss, new_state = jax.jit(fwd).lower(
            params, state, x, key).compile(_FAST_COMPILE)(params, state, x,
                                                          key)

    class Key(_Signs):
        def child(self, index):
            return self if index == 0 else Replay(draws)

    model.train()
    got, gloss, stats = robust.multi_sample_forward(
        model, _t(x), _t(x), 0.03, Key(signs.astype(np.float64)),
        return_state=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(gloss.detach()), float(sloss),
                               rtol=1e-9)
    # the running statistics of the packed forward
    bn = model.bn0 if name == "cifar10lownoise" else model.bn1
    wstate = new_state["bn0" if name == "cifar10lownoise" else "bn1"]
    np.testing.assert_allclose(stats[bn][0].numpy(),
                               np.asarray(wstate["running_mean"]), **TOL)


def test_cifar10lownoise_multi_sample_matches_jax_f64(x64):  # noqa: F811
    from scale_imagenet_tpu.models.ttnet_cifar import \
        cifar10lownoise_multi_sample as jms
    from scale_imagenet_tpu_torch.models.ttnet_cifar import \
        cifar10lownoise_multi_sample as pms

    jm, params, state, md, model = zoo_pair("cifar10lownoise", {}, seed=15)
    x, x_adv = images((2, 32, 32, 3), 16), images((2, 32, 32, 3), 17)
    key = jax.random.PRNGKey(9)
    signs = np.asarray(jax.random.randint(jax.random.split(key)[0], x.shape,
                                          0, 2)).astype(np.float64)
    f = jax.jit(lambda p, s, a, b, k: jms(p, s, jm.config, a, b, 0.02, k))
    logits, loss = f.lower(params, state, x, x_adv, key).compile(
        _FAST_COMPILE)(params, state, x, x_adv, key)
    got, gloss = pms(model, _t(x), _t(x_adv), 0.02, _Signs(signs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(gloss), float(loss), rtol=1e-9)


@pytest.mark.parametrize("name,kw", [
    ("cifar10lownoise", {}),
    ("model_general", dict(type_weights_preprocessing="bin",
                           type_weights_final="ter"))])
def test_bn_observer_sees_jax_pairs(x64, name, kw):  # noqa: F811
    jm, params, state, md, model = zoo_pair(name, kw, seed=17)
    x = images((4, 32, 32, 3), 18)

    def fwd(p, s, a):
        with jrobust.bn_internals_collector() as c:
            jm.apply(p, s, a, training=True)
        return c.pairs

    want = jax.jit(fwd).lower(params, state, x).compile(_FAST_COMPILE)(
        params, state, x)
    with robust.bn_internals_collector() as c, torch.no_grad():
        model(_t(x), {})
    assert len(c.pairs) == len(want) == 1
    assert not jnorm.BN_OBSERVERS
    for (gs, gb), (ws, wb) in zip(c.pairs, want):
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)
