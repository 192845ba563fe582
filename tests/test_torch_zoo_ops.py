"""The primitives of the zoo families against the JAX package on the CPU
in f64, each with its gradient where the JAX function defines one (a
``custom_vjp`` or a straight-through estimator): ``input_quantize``, the
six weight binarizers (the two with the weight decay in their gradient
are ``torch.autograd.Function``s), ``bin_conv2d`` and ``bin_linear``
(``positive``, ``abs_weight``), ``stats_bn`` (training, eval and
``eval_with_bn``; per-channel and scalar scale; 2-D and 4-D inputs) and
``scale_bias_layer``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, images, x64  # noqa: F401

from scale_imagenet_tpu.layers import conv as jconv, norm as jnorm
from scale_imagenet_tpu.ops import quantize as jquantize, \
    weights as jweights
from scale_imagenet_tpu_torch.convert.from_jax import _conv
from scale_imagenet_tpu_torch.layers import BinConv2d, BinLinear, \
    ScaleBias, StatsBN, bin_conv2d, bin_linear, scale_bias_layer, stats_bn
from scale_imagenet_tpu_torch.ops import input_quantize
from scale_imagenet_tpu_torch.ops import weights as pweights

# the package exports a function under the module's name
jlinear = importlib.import_module("scale_imagenet_tpu.layers.linear")
TOL = dict(rtol=1e-9, atol=1e-9)

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _t(a, grad: bool = False) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **{**TOL, **kw})


def test_input_quantize_and_gradient(x64):  # noqa: F811
    x = images((3, 5, 5, 2), 1)
    g = np.random.default_rng(2).standard_normal(x.shape)
    want, vjp = jax.vjp(lambda a: jquantize.input_quantize(a, 0.0625), x)
    xt = _t(x, True)
    got = input_quantize(xt, 0.0625)
    got.backward(_t(g))
    _close(got, want)
    _close(xt.grad, vjp(g)[0])


@pytest.mark.parametrize("kind", sorted(jweights.WEIGHT_BINARIZERS))
def test_weight_binarizers_and_gradients(x64, kind):  # noqa: F811
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 6)) * 0.012
    mask = rng.standard_normal((4, 6)) * 0.01
    g = rng.standard_normal((4, 6))
    masked = jweights.uses_weight_mask(kind)
    assert masked == pweights.uses_weight_mask(kind)
    args = (w, mask) if masked else (w,)
    want, vjp = jax.vjp(lambda *a: jweights.binarize_weights(
        kind, a[0], a[1] if masked else None, weight_decay=1e-3), *args)
    ts = [_t(a, True) for a in args]
    got = pweights.binarize_weights(kind, ts[0], ts[1] if masked else None,
                                    weight_decay=1e-3)
    got.backward(_t(g))
    _close(got, want)
    for t, wg in zip(ts, vjp(g)):
        _close(t.grad, wg)
    with pytest.raises(ValueError, match="requires a weight_mask") \
            if masked else torch.no_grad():
        pweights.binarize_weights(kind, ts[0])


@pytest.mark.parametrize("binarizer,positive,rounding", [
    ("ternary_mask", False, True), ("ternary_mask", True, False),
    ("quant3", False, False), ("bin01", True, True)])
def test_bin_conv2d_and_gradients(x64, binarizer, positive,  # noqa: F811
                                  rounding):
    p = jconv.init_bin_conv2d(jax.random.PRNGKey(4), 4, 6, 3, groups=2,
                              binarizer=binarizer, dtype=jnp.float64)
    p = jax.tree.map(np.asarray, p)
    x = images((2, 7, 7, 4), 5)
    g = np.random.default_rng(6).standard_normal((2, 3, 3, 6))

    def f(pp, xx):
        return jconv.bin_conv2d(pp, xx, stride=2, padding=0, groups=2,
                                binarizer=binarizer, rounding=rounding,
                                positive=positive)

    want, vjp = jax.vjp(f, p, x)
    gp, gx = vjp(g)
    conv = BinConv2d(4, 6, 3, groups=2, binarizer=binarizer).double()
    with torch.no_grad():
        conv.weight.copy_(_conv(p["weight"]))
        if "weight_mask" in p:
            conv.weight_mask.copy_(_conv(p["weight_mask"]))
    xt = _t(np.moveaxis(x, -1, 1), True)
    got = bin_conv2d(xt, conv, stride=2, groups=2, rounding=rounding,
                     positive=positive)
    got.backward(_t(np.moveaxis(g, -1, 1)))
    _close(got.permute(0, 2, 3, 1), want)
    _close(xt.grad.permute(0, 2, 3, 1), gx)
    _close(conv.weight.grad, _conv(gp["weight"]))
    if "weight_mask" in p:
        _close(conv.weight_mask.grad, _conv(gp["weight_mask"]))


@pytest.mark.parametrize("binarizer,positive,abs_weight", [
    ("ternary_mask", True, False), ("ternary_mask", False, True),
    ("quant3", True, False), ("ternary", False, False)])
def test_bin_linear_and_gradients(x64, binarizer, positive,  # noqa: F811
                                  abs_weight):
    p = jlinear.init_bin_linear(jax.random.PRNGKey(7), 12, 5,
                                binarizer=binarizer, dtype=jnp.float64)
    p = jax.tree.map(np.asarray, p)
    x = images((3, 12), 8) * 4
    g = np.random.default_rng(9).standard_normal((3, 5))
    want, vjp = jax.vjp(lambda pp, xx: jlinear.bin_linear(
        pp, xx, binarizer=binarizer, positive=positive,
        abs_weight=abs_weight), p, x)
    gp, gx = vjp(g)
    lin = BinLinear(12, 5, binarizer).double()
    with torch.no_grad():
        lin.weight.copy_(_t(p["weight"].T))
        if "weight_mask" in p:
            lin.weight_mask.copy_(_t(p["weight_mask"].T))
    xt = _t(x, True)
    got = bin_linear(xt, lin, positive=positive, abs_weight=abs_weight)
    got.backward(_t(g))
    _close(got, want)
    _close(xt.grad, gx)
    _close(lin.weight.grad, gp["weight"].T)
    if "weight_mask" in p:
        _close(lin.weight_mask.grad, gp["weight_mask"].T)


@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("mode", ["train", "eval", "eval_with_bn"])
@pytest.mark.parametrize("rank", [2, 4])
def test_stats_bn_and_gradients(x64, mode, scalar, rank):  # noqa: F811
    rng = np.random.default_rng(10)
    c = 5
    shape = (6, c) if rank == 2 else (3, 4, 4, c)
    x = rng.standard_normal(shape) * 2 + 1
    g = rng.standard_normal(shape)
    dim = 1 if scalar else c
    params = {"weight": rng.uniform(0.5, 2, dim),
              "bias": rng.standard_normal(c)}
    state = {"running_mean": rng.standard_normal(c),
             "running_var": rng.uniform(0.5, 2, dim)}

    def f(pp, xx):
        y, new_state, _ = jnorm.stats_bn(
            pp, state, xx, training=mode == "train",
            eval_with_bn=mode == "eval_with_bn", use_scalar_scale=scalar)
        return y, new_state

    (want, want_state), vjp = jax.vjp(f, params, x)
    gp, gx = vjp((g, jax.tree.map(np.zeros_like, want_state)))
    bn = StatsBN(c, use_scalar_scale=scalar).double()
    with torch.no_grad():
        for k, v in {**params, **state}.items():
            getattr(bn, k).copy_(_t(v))
    to_nchw = (lambda a: np.moveaxis(a, -1, 1)) if rank == 4 else \
        (lambda a: a)
    xt = _t(to_nchw(x), True)
    stats = {} if mode == "train" else None
    got = stats_bn(bn, xt, stats, eval_with_bn=mode == "eval_with_bn")
    got.backward(_t(to_nchw(g)))
    _close(to_nchw(got.detach().numpy()) if rank == 2 else
           np.moveaxis(got.detach().numpy(), 1, -1), want)
    _close(to_nchw(xt.grad.numpy()) if rank == 2 else
           np.moveaxis(xt.grad.numpy(), 1, -1), gx)
    _close(bn.weight.grad, gp["weight"])
    _close(bn.bias.grad, gp["bias"])
    if mode == "train":
        mean, var = stats[bn]
        _close(mean, want_state["running_mean"])
        _close(var, want_state["running_var"])
    else:
        assert stats is None


def test_scale_bias_layer(x64):  # noqa: F811
    assert float(jnorm.init_scale_bias_layer(7)["scale"]) == \
        pytest.approx(1 / 7)
    p = {"scale": np.float64(0.3), "bias": np.arange(7.0)}
    x = images((2, 7), 11)
    layer = ScaleBias(7).double()
    assert float(layer.scale.detach()) == pytest.approx(1 / 7)
    with torch.no_grad():
        layer.scale.fill_(0.3)
        layer.bias.copy_(_t(p["bias"]))
    _close(scale_bias_layer(layer, _t(x)),
           jnorm.scale_bias_layer(p, x))
