"""The port's ops, layers, stem and blocks against the JAX package, in f64.

Float comparisons use 1e-9: both sides compute in float64, so they differ
only by summation order (~1e-15 relative).  Heaviside outputs must be equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, nchw, perturb_state, tree_np, x64  # noqa: F401

jconv, jlinear, jnorm, jpool, jbt, jmh = (
    importlib.import_module(f"scale_imagenet_tpu.{m}") for m in (
        "layers.conv", "layers.linear", "layers.norm", "layers.pool",
        "models.block_tt", "models.multihead"))
from scale_imagenet_tpu.models.classifier import classifier_scale as \
    jclassifier_scale
from scale_imagenet_tpu.ops.binarize import binarize01_act as jbinarize
from scale_imagenet_tpu.ops.poly import polynome_act as jpoly
from scale_imagenet_tpu.pallas import stem as jstem
from scale_imagenet_tpu_torch.convert.from_jax import _conv as hwio_to_oihw
from scale_imagenet_tpu_torch.kernels import stem as tstem
from scale_imagenet_tpu_torch.layers import avg_pool, batch_norm, \
    bn_scale_bias, constant_pad2d, conv2d, flatten, linear, zero_pad2d
from scale_imagenet_tpu_torch.models import block_tt as tbt, multihead as tmh
from scale_imagenet_tpu_torch.models.classifier import ClassifierScale, \
    classifier_scale
from scale_imagenet_tpu_torch.ops import Binarize01Act, binarize01_act, \
    gelu, heaviside01, polynome_act

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

TOL = dict(rtol=1e-9, atol=1e-9)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _nchw_t(a):
    return _t(a).permute(0, 3, 1, 2)


def test_heaviside_and_binarize(x64):
    x = np.concatenate([images((200,), 0) * 2 - 1, [0.0, -0.0, 1e-300]])
    ref = np.asarray(jbinarize(jnp.asarray(x)))
    np.testing.assert_array_equal(binarize01_act(_t(x)).detach().numpy(), ref)
    np.testing.assert_array_equal(heaviside01(_t(x)).detach().numpy(), ref)
    np.testing.assert_array_equal(Binarize01Act()(_t(x)).detach().numpy(), ref)
    # the dead zone needs its coin flips' key (tests/test_torch_noisy.py)
    with pytest.raises(ValueError, match="T != 0 needs a noise key"):
        binarize01_act(_t(x), T=0.1)
    assert set(Binarize01Act().state_dict()) == {"grad_scale"}


def test_gelu_and_poly(x64):
    import jax

    x = (images((500,), 1) - 0.5) * 12
    np.testing.assert_allclose(
        gelu(_t(x)).detach().numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)), **TOL)
    np.testing.assert_allclose(polynome_act(_t(x)).detach().numpy(),
                               np.asarray(jpoly(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("k,stride,padding,groups",
                         [(3, 1, 1, 1), (4, 2, 2, 8), (1, 1, 0, 4),
                          (7, 2, 3, 1)])
def test_conv2d_grouped(x64, k, stride, padding, groups):
    rng = np.random.default_rng(k * 10 + groups)
    cin, cout = 8, 16
    x = rng.standard_normal((2, 9, 11, cin))
    w = rng.standard_normal((k, k, cin // groups, cout))
    ref = jconv.conv2d({"weight": jnp.asarray(w)}, jnp.asarray(x),
                       stride=stride, padding=padding, groups=groups)
    got = conv2d(_nchw_t(x), hwio_to_oihw(w), stride=stride,
                 padding=padding, groups=groups)
    np.testing.assert_allclose(nchw(got), np.asarray(ref), **TOL)


def _bn_pair(c, seed):
    rng = np.random.default_rng(seed)
    p = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.standard_normal(c)}
    s = {"running_mean": rng.standard_normal(c),
         "running_var": rng.uniform(0.5, 2.0, c)}
    bn = torch.nn.BatchNorm2d(c).double()
    with torch.no_grad():
        for k, v in {**p, **s}.items():
            getattr(bn, k).copy_(_t(v))
    return p, s, bn


def test_batch_norm_eval(x64):
    p, s, bn = _bn_pair(6, 0)
    jp, js = jax_tree(p), jax_tree(s)
    x4 = images((2, 5, 5, 6), 2) * 4 - 2
    ref4, _ = jnorm.batch_norm(jp, js, jnp.asarray(x4))
    np.testing.assert_allclose(nchw(batch_norm(bn, _nchw_t(x4))),
                               np.asarray(ref4), **TOL)
    x2 = images((7, 6), 3)
    ref2, _ = jnorm.batch_norm(jp, js, jnp.asarray(x2))
    np.testing.assert_allclose(batch_norm(bn, _t(x2)).detach().numpy(),
                               np.asarray(ref2), **TOL)
    scale, bias = bn_scale_bias(bn)
    rs, rb = jnorm.bn_scale_bias(jp, js)
    np.testing.assert_allclose(scale.detach().numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(bias.detach().numpy(), np.asarray(rb), **TOL)


def jax_tree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_pool_pad_flatten(x64):
    x = images((2, 7, 9, 3), 4)
    np.testing.assert_allclose(nchw(avg_pool(_nchw_t(x), 2)),
                               np.asarray(jpool.avg_pool(jnp.asarray(x), 2)),
                               **TOL)
    for pad in [(1, 0, 1, 0), (0, 2, 0, 2), (0, 0, 0, 1), (0, 1, 0, 0)]:
        np.testing.assert_array_equal(
            nchw(zero_pad2d(_nchw_t(x), pad)),
            np.asarray(jpool.zero_pad2d(jnp.asarray(x), pad)))
    for pad in [2, (1, 2, 3, 4)]:
        np.testing.assert_array_equal(
            nchw(constant_pad2d(_nchw_t(x), pad, 0.5)),
            np.asarray(jpool.constant_pad2d(jnp.asarray(x), pad, 0.5)))
    np.testing.assert_array_equal(flatten(_nchw_t(x)).detach().numpy(),
                                  np.asarray(jpool.flatten(jnp.asarray(x))))


def test_linear(x64):
    rng = np.random.default_rng(5)
    x, w, b = (rng.standard_normal(s) for s in ((4, 12), (12, 7), (7,)))
    ref = jlinear.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                         jnp.asarray(x))
    np.testing.assert_allclose(linear(_t(x), _t(w.T), _t(b)).detach().numpy(),
                               np.asarray(ref), **TOL)


def test_s2d_stem(x64):
    rng = np.random.default_rng(6)
    w7 = rng.standard_normal((7, 7, 3, 16))
    x = images((2, 32, 40, 3), 7)
    np.testing.assert_allclose(
        tstem.fold_avgpool_into_stem_weight(hwio_to_oihw(w7)).detach().numpy(),
        np.transpose(np.asarray(jstem.fold_avgpool_into_stem_weight(
            jnp.asarray(w7))), (3, 2, 0, 1)), **TOL)
    ref = jstem.space_to_depth_stem(jnp.asarray(x), jnp.asarray(w7))
    got = tstem.space_to_depth_stem(_nchw_t(x), hwio_to_oihw(w7))
    np.testing.assert_allclose(nchw(got), np.asarray(ref), **TOL)
    # the fold equals the literal avgpool -> conv7 s2 p3
    lit = conv2d(avg_pool(_nchw_t(x), 2), hwio_to_oihw(w7), stride=2,
                 padding=3)
    np.testing.assert_allclose(got.detach().numpy(), lit.detach().numpy(), **TOL)


BLOCK_CFGS = [
    dict(in_planes=16, out_planes=16, k=4, padding=2, stride=2,
         groupsici=16),                       # flagship heads 1/2
    dict(in_planes=16, out_planes=16, k=1, padding=0, groupsici=4),
    dict(in_planes=8, out_planes=8, k=2, padding=1, stride=2, groupsici=8),
    dict(in_planes=16, out_planes=16, k=1, padding=0, groupsici=4,
         last=True),                          # ReLU fuse head
]


def _block_pair(kw, seed):
    import jax

    jcfg = jbt.BlockTTConfig(**kw)
    p, s = jbt.init_block_tt(jax.random.PRNGKey(seed), jcfg)
    p, s = tree_np(p, np.float64), perturb_state(tree_np(s, np.float64),
                                                 seed)
    block = tbt.BlockTT(tbt.BlockTTConfig(**kw)).double().eval()
    sd = {}
    for name in ("conv1", "conv2"):
        sd[f"{name}.weight"] = hwio_to_oihw(p[name]["weight"])
    for name in ("bn1", "bn2"):
        for k in ("weight", "bias"):
            sd[f"{name}.{k}"] = _t(p[name][k])
        for k in ("running_mean", "running_var"):
            sd[f"{name}.{k}"] = _t(s[name][k])
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    sd["act.grad_scale"] = torch.tensor(1.0)
    block.load_state_dict(sd, strict=True)
    return jcfg, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s), \
        block


@pytest.mark.parametrize("i", range(len(BLOCK_CFGS)))
def test_block_tt(x64, i):
    kw = BLOCK_CFGS[i]
    jcfg, p, s, block = _block_pair(kw, i)
    x = (images((2, 9, 9, kw["in_planes"]), 10 + i) < 0.5).astype(np.float64)
    ref, _ = jbt.block_tt(p, s, jcfg, jnp.asarray(x))
    got = tbt.block_tt(block, _nchw_t(x))
    np.testing.assert_allclose(nchw(got), np.asarray(ref), **TOL)
    if not kw.get("last"):
        assert set(np.unique(nchw(got))) <= {0.0, 1.0}
    assert tbt.block_tt_out_size(block.cfg, 9, 9) == \
        jbt.block_tt_out_size(jcfg, 9, 9)
    assert block.cfg.n_bits == jcfg.n_bits


@pytest.mark.parametrize("hw,stride,last", [(56, 2, False), (29, 2, True),
                                            (16, 1, False)])
def test_multihead_block(x64, hw, stride, last):
    import jax

    kw = dict(in_planes=16, out_planes=16, stride=stride, last=last)
    jcfg = jmh.MultiHeadConfig(**kw)
    tcfg = tmh.MultiHeadConfig(**kw)
    assert tcfg.head_cfgs() == {
        i: tbt.BlockTTConfig(**{f: getattr(c, f) for f in (
            "in_planes", "out_planes", "k", "t", "padding", "stride",
            "groupsici", "last")}) for i, c in jcfg.head_cfgs().items()}
    assert tmh.multihead_out_size(tcfg, hw, hw) == \
        jmh.multihead_out_size(jcfg, hw, hw)
    p, s = jmh.init_multihead(jax.random.PRNGKey(hw), jcfg)
    p, s = tree_np(p, np.float64), perturb_state(tree_np(s, np.float64), hw)
    block = tmh.MultiHeadBlock(tcfg).double().eval()
    from scale_imagenet_tpu_torch.convert.from_jax import _HEADS, _bn, _conv
    sd = {"act.grad_scale": torch.tensor(1.0)}
    for ours, name in _HEADS:
        sd[f"{name}.conv1.weight"] = _conv(p[ours]["conv1"]["weight"])
        sd[f"{name}.conv2.weight"] = _conv(p[ours]["conv2"]["weight"])
        _bn(sd, f"{name}.bn1", p[ours]["bn1"], s[ours]["bn1"])
        _bn(sd, f"{name}.bn2", p[ours]["bn2"], s[ours]["bn2"])
        sd[f"{name}.act.grad_scale"] = torch.tensor(1.0)
    block.load_state_dict(sd, strict=True)
    x = (images((2, hw, hw, 16), hw) < 0.5).astype(np.float64)
    ref, _ = jax.jit(jmh.multihead_block, static_argnums=2)(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s), jcfg,
        jnp.asarray(x))
    got = tmh.multihead_block(block, _nchw_t(x))
    np.testing.assert_allclose(nchw(got), np.asarray(ref), **TOL)


def test_channel_interleave():
    x = np.arange(2 * 3 * 4 * 8, dtype=np.float64).reshape(2, 3, 4, 8)
    np.testing.assert_array_equal(
        nchw(tmh.channel_interleave(_nchw_t(x), 4)),
        np.asarray(jmh.channel_interleave(jnp.asarray(x), 4)))


def test_fixup_table_matches_jax():
    for xw in (56, 29, 57, 16, 15, 8, 58, 30, 9, 7, 4):
        for out1w in (58, 57, 29, 6, 5, xw):
            assert tmh.FIXUP_RULES["v2small"](xw, out1w) == \
                jmh.FIXUP_RULES["v2small"](xw, out1w)


def test_classifier_scale(x64):
    rng = np.random.default_rng(8)
    fc, inter, out = 24, 10, 6
    p = {"lin1": {"weight": rng.standard_normal((fc, inter))},
         "bn": {"weight": rng.uniform(0.5, 1.5, inter),
                "bias": rng.standard_normal(inter)},
         "lin2": {"weight": rng.standard_normal((inter, out)),
                  "bias": rng.standard_normal(out)}}
    s = {"bn": {"running_mean": rng.standard_normal(inter),
                "running_var": rng.uniform(0.5, 2, inter)}}
    head = ClassifierScale(fc, inter, out).double()
    with torch.no_grad():
        head.lin1.weight.copy_(_t(p["lin1"]["weight"].T))
        head.lin2.weight.copy_(_t(p["lin2"]["weight"].T))
        head.lin2.bias.copy_(_t(p["lin2"]["bias"]))
        for k in ("weight", "bias"):
            getattr(head.BN2, k).copy_(_t(p["bn"][k]))
        for k in ("running_mean", "running_var"):
            getattr(head.BN2, k).copy_(_t(s["bn"][k]))
    x = rng.standard_normal((3, fc))
    import jax

    ref, _ = jclassifier_scale(jax.tree.map(jnp.asarray, p),
                               jax.tree.map(jnp.asarray, s), jnp.asarray(x))
    with torch.no_grad():
        got = classifier_scale(head.eval(), _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
