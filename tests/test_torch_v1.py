"""The v1 ImageNet family's parts and its 32x32 clones against the JAX
package on the CPU.

``activation_quantize`` matches JAX's forward exactly and its STE gradient
to 1e-12 in f64; ``block_resnet`` (the CIFAR cell) and ``block_resnet_bn``
(the v1 cell) match in f64 to 1e-9, in eval and with batch statistics;
the v1 multi-head cell matches in f64 to 1e-9 at every shape a
``_fixups_v1`` table row covers, with its output size; the registry has
the 20 names with JAX's configs.  Whole models:
``tests/test_torch_v1_models.py`` (the 32x32 clones, training, ``--ckpt``
and the CLI), ``tests/test_torch_v1_imagenet.py`` (224x224) and
``tests/test_torch_v1_cli.py`` (the refusals).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, images, perturb_state, tree_np, \
    x64  # noqa: F401
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu.models import ttnet_cifar as jcifar
from scale_imagenet_tpu.models import ttnet_imagenet_v1 as jv1
from scale_imagenet_tpu.ops import quantize as jq
from scale_imagenet_tpu_torch.convert.from_jax import _bn, _conv
from scale_imagenet_tpu_torch.models import get_model, list_models
from scale_imagenet_tpu_torch.models import ttnet_cifar as tcifar
from scale_imagenet_tpu_torch.models import ttnet_imagenet_v1 as tv1
from scale_imagenet_tpu_torch.ops import quantize as tq

TOL = dict(rtol=1e-9, atol=1e-9)
W = dict(nfilter=2, tfilter=2)
CIFAR = [tv1.cifar_name(n) for n in tv1.V1_STAGES]


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("a_bit", [1, 2, 3, 32])
def test_activation_quantize_matches_jax(x64, a_bit):  # noqa: F811
    x = np.random.default_rng(a_bit).uniform(-0.5, 1.5, 500)
    g = np.random.default_rng(9).standard_normal(x.shape)
    for jf, tf in ((lambda a: jq.activation_quantize(a, a_bit),
                    lambda a: tq.activation_quantize(a, a_bit)),
                   (lambda a: jq.uniform_quantize(a, a_bit),
                    lambda a: tq.uniform_quantize(a, a_bit)),
                   (jq.ste_round, tq.ste_round)):
        want, vjp = jax.vjp(jf, jnp.asarray(x))
        xt = _t(x).requires_grad_()
        got = tf(xt)
        got.backward(_t(g))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(
            jnp.asarray(g))[0]), rtol=1e-12, atol=1e-12)


def _cell(jcfg, tcfg, seed: int):
    """One JAX ``init_block_resnet`` (BN statistics perturbed) and the
    port's cell holding the same values."""
    p, s = jcifar.init_block_resnet(jax.random.PRNGKey(seed), jcfg)
    p = tree_np(p, np.float64)
    s = perturb_state(tree_np(s, np.float64), seed, scale=0.2)
    block = tcifar.BlockResnet(tcfg).double()
    sd = {"conv1.weight": _conv(p["conv1"]["weight"]),
          "conv2.weight": _conv(p["conv2"]["weight"])}
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    _bn(sd, "bn2", p["bn2"], s["bn2"])
    block.load_state_dict(sd, strict=True)
    return p, s, block


@pytest.mark.parametrize("kw", [
    dict(k=3, padding=1, stride=1, groupsici=2),
    dict(k=4, padding=2, stride=2, groupsici=4, a_bit=1),
    dict(k=2, padding=1, stride=1, groupsici=1, last=True),
    dict(k=7, padding=3, stride=2, groupsici=8, a_bit=3),
], ids=["k3", "k4s2_abit1", "k2_last", "k7s2_dw"])
def test_block_resnet_cells_match_jax(x64, kw):  # noqa: F811
    """Both cell orders, eval and training (batch statistics, the new
    running statistics)."""
    jcfg = jcifar.BlockResnetConfig(8, 8, **kw)
    p, s, block = _cell(jcfg, tcifar.BlockResnetConfig(8, 8, **kw), 3)
    x = images((3, 11, 11, 8), 4) * 2 - 1
    xt = _t(x.transpose(0, 3, 1, 2))
    for jf, tf in ((jcifar.block_resnet, tcifar.block_resnet),
                   (jv1.block_resnet_bn, tv1.block_resnet_bn)):
        for training in (False, True):
            want, new = jax.jit(lambda a, f=jf, t=training: f(
                p, s, jcfg, a, training=t))(jnp.asarray(x))
            stats = {} if training else None
            got = tf(block, xt, stats)
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want).transpose(0, 3, 1, 2),
                                       **TOL)
            if training:
                for name in ("bn1", "bn2"):
                    mean, var = stats[getattr(block, name)]
                    np.testing.assert_allclose(
                        mean.numpy(), new[name]["running_mean"], **TOL)
                    np.testing.assert_allclose(
                        var.numpy(), new[name]["running_var"], **TOL)
    assert tcifar.block_resnet_out_size(block.cfg, 11, 9) == \
        jcifar.block_resnet_out_size(jcfg, 11, 9)


def _table_shapes():
    """Every (variant, stride, input width) a ``_fixups_v1`` row covers."""
    shapes = [("vf_imgnet", s, w) for s in (1, 2) for w in (56, 30, 16)]
    shapes += [("vf_17l", 1, w) for w in (8, 14)]
    shapes += [("vf_17l", 2, w) for w in (16, 13, 10, 6)]
    shapes += [("vf_pad", 1, w) for w in (8, 14, 9, 11, 12, 20, 18, 16)]
    shapes += [("vf_pad", 2, w) for w in (18, 14, 20, 10, 6)]
    shapes += [("vf_7x", 2, w) for w in (10, 6)]
    return shapes


def test_fixup_tables_and_sizes_match_jax():
    for fixup in ("imgnet", "17l", "pad", "7x", None):
        for stride in (1, 2):
            for xw in range(4, 60):
                assert tv1._fixups_v1(fixup, stride, xw) == \
                    jv1._fixups_v1(fixup, stride, xw)
    for variant, stride, xw in _table_shapes():
        assert any(tv1._fixups_v1(tv1.V1_VARIANTS[variant]["fixup"], stride,
                                  xw)), (variant, stride, xw)
        for cin, cout in ((4, 4), (4, 8), (8, 16)):
            t = tv1.V1MultiHeadConfig(cin, cout, stride=stride,
                                      variant=variant)
            j = jv1.V1MultiHeadConfig(cin, cout, stride=stride,
                                      variant=variant)
            assert tv1.v1_multihead_out_size(t, xw, xw) == \
                jv1.v1_multihead_out_size(j, xw, xw)
            assert t.convf_cfg().groupsici == j.convf_cfg().groupsici


def _cell_trees(cell: tcifar.BlockResnet) -> tuple[dict, dict]:
    """A port cell's values as the JAX package's ``(params, state)``."""
    sd = {k: v.detach().numpy() for k, v in cell.state_dict().items()}
    bn = {n: ({"weight": sd[f"{n}.weight"], "bias": sd[f"{n}.bias"]},
              {"running_mean": sd[f"{n}.running_mean"],
               "running_var": sd[f"{n}.running_var"]}) for n in ("bn1", "bn2")}
    return ({"conv1": {"weight": sd["conv1.weight"].transpose(2, 3, 1, 0)},
             "bn1": bn["bn1"][0],
             "conv2": {"weight": sd["conv2.weight"].transpose(2, 3, 1, 0)},
             "bn2": bn["bn2"][0]},
            {"bn1": bn["bn1"][1], "bn2": bn["bn2"][1]})


@pytest.mark.parametrize("variant,stride,xw", _table_shapes())
def test_v1_multihead_matches_jax_at_table_shapes(x64, variant, stride,
                                                  xw):  # noqa: F811
    """The port's seeded cell (BN statistics perturbed) in both packages:
    one compile of JAX's cell a shape, at a low XLA optimisation level."""
    jcfg = jv1.V1MultiHeadConfig(4, 4 * stride, stride=stride,
                                 variant=variant)
    tcfg = tv1.V1MultiHeadConfig(4, 4 * stride, stride=stride,
                                 variant=variant)
    torch.manual_seed(xw)
    block = tv1.V1MultiHeadBlock(tcfg).double()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    params, state = {}, {}
    for j in tcfg.conv_heads:
        params[f"conv{j}"], state[f"conv{j}"] = _cell_trees(
            getattr(block, f"Block_conv{j}"))
    params["convf"], state["convf"] = _cell_trees(block.Block_convf)
    x = images((1, xw, xw, 4), xw) * 2 - 1
    fwd = jax.jit(lambda p, s, a: jv1.v1_multihead(p, s, jcfg, a)[0])
    want = fwd.lower(params, state, x).compile(_FAST_COMPILE)(
        params, state, x)
    with torch.no_grad():
        got = block(_t(x.transpose(0, 3, 1, 2))).numpy()
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert got.shape[2:] == tv1.v1_multihead_out_size(tcfg, xw, xw)
    np.testing.assert_allclose(got, want, **TOL)


def test_registry_has_the_v1_names():
    names = set(list_models())
    assert set(tv1.V1_STAGES) | set(CIFAR) <= names
    # every name of the JAX registry since the zoo families
    assert len(list_models()) == 71
    from scale_imagenet_tpu.models import get_model as jget

    for name in list(tv1.V1_STAGES) + CIFAR:
        for kw in ({}, W):
            md, jm = get_model(name, **kw), jget(name, **kw)
            assert md.name == jm.name and not md.stochastic
            assert md.config.fcsize == jm.config.fcsize
            assert md.config.feature_shape() == jm.config.feature_shape()
            assert md.config.image_size == jm.config.image_size
            assert md.config.num_classes == jm.config.num_classes
