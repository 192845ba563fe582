"""The port's fused pointwise TT-block, its polynomial erf, and the gate
that routes k=1 blocks to it.

The plain version (what the wrapper runs for a CPU tensor) is held against
the JAX package's Pallas kernels in interpret mode on the shapes of
``tests/test_pallas.py``: Heaviside outputs equal, ReLU outputs to
``rtol=1e-5, atol=1e-6`` as there.  ``fast_erf`` matches JAX's to 2e-7 and
``scipy.special.erf`` to 1.5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, tree_np

from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg, \
    init_block_tt
from scale_imagenet_tpu.ops.gelu import fast_erf as jfast_erf, \
    fast_gelu as jfast_gelu
from scale_imagenet_tpu.pallas import fused_block as jfb
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch.compile.truth_table import block_truth_table
from scale_imagenet_tpu_torch.convert.from_jax import _bn, _conv
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.models import block_tt as block_mod
from scale_imagenet_tpu_torch.models.block_tt import BlockTT, BlockTTConfig
from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, stem, \
    ttnet_imagenet_apply
from scale_imagenet_tpu_torch.ops.gelu import fast_erf, fast_gelu

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _block(kw, seed=0, dtype=np.float32):
    """One JAX init feeding a JAX block and the port's ``BlockTT``, with
    BN running statistics moved off their defaults as in test_pallas."""
    cfg = JBlockCfg(**kw)
    p, s = init_block_tt(jax.random.PRNGKey(seed), cfg)
    s = jax.tree.map(lambda a: a + 0.1, s)
    p, s = tree_np(p, dtype), tree_np(s, dtype)
    block = BlockTT(BlockTTConfig(**kw)).eval()
    if dtype == np.float64:
        block = block.double()
    sd = {"conv1.weight": _conv(p["conv1"]["weight"]),
          "conv2.weight": _conv(p["conv2"]["weight"]),
          "act.grad_scale": torch.tensor(1.0)}
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    _bn(sd, "bn2", p["bn2"], s["bn2"])
    block.load_state_dict(sd, strict=True)
    return cfg, p, s, block


def _bits(shape, seed):
    return (images(shape, seed) < 0.5).astype(np.float32)


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("last", [False, True])
def test_plain_matches_jax_interpret(variant, last):
    kw = dict(in_planes=256, out_planes=256 if last else 128, k=1,
              padding=0, groupsici=16, last=last)
    cfg, p, s, block = _block(kw)
    x = _bits((2, 5, 5, 256), 1)
    jfn = jfb.fused_block_tt_pointwise if variant == "v1" \
        else jfb.fused_block_tt_pointwise_v2
    ref = np.asarray(jfn(p, s, cfg, jnp.asarray(x), interpret=True))
    fn = FB.fused_block_tt_pointwise if variant == "v1" \
        else FB.fused_block_tt_pointwise_v2
    with torch.no_grad():
        got = fn(block, torch.from_numpy(x)).numpy()
    if last:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def test_plain_matches_jax_non_pow2_groups():
    """g = 12: the TPU wrapper's bundle falls back to all 12 groups; the
    port has no bundles, and the plain version matches."""
    kw = dict(in_planes=192, out_planes=192, k=1, padding=0, groupsici=12)
    cfg, p, s, block = _block(kw)
    x = _bits((2, 3, 3, 192), 2)
    ref = np.asarray(jfb.fused_block_tt_pointwise_v2(
        p, s, cfg, jnp.asarray(x), interpret=True))
    with torch.no_grad():
        got = FB.fused_block_tt_pointwise_v2(block, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_bf16_in_bf16_out(variant):
    kw = dict(in_planes=128, out_planes=128, k=1, padding=0, groupsici=8)
    cfg, p, s, block = _block(kw)
    x = torch.from_numpy(_bits((2, 3, 3, 128), 3)).to(torch.bfloat16)
    fn = FB.fused_block_tt_pointwise if variant == "v1" \
        else FB.fused_block_tt_pointwise_v2
    with torch.no_grad():
        got = fn(block, x)
    assert got.dtype == torch.bfloat16
    assert set(got.float().unique().tolist()) <= {0.0, 1.0}
    # bits are exact in bf16: the same function as the f32 input
    assert torch.equal(got.float(), fn(block, x.float()))


@pytest.mark.parametrize("kw", [
    dict(in_planes=256, out_planes=128, k=1, padding=0, groupsici=16),
    dict(in_planes=16, out_planes=16, k=1, padding=0, groupsici=4,
         last=True)])
def test_pointwise_params_match_jax(kw):
    cfg, p, s, block = _block(kw, seed=4)
    for got, want in zip(FB.block_tt_pointwise_params(block),
                         jfb.block_tt_pointwise_params(p, s, cfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fast_erf_matches_jax_and_scipy():
    from scipy.special import erf

    x = np.linspace(-6, 6, 120001).astype(np.float32)
    got = fast_erf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfast_erf(jnp.asarray(x))),
                               rtol=0, atol=2e-7)
    assert np.abs(got - erf(x.astype(np.float64))).max() < 1.5e-6
    np.testing.assert_allclose(
        fast_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jfast_gelu(jnp.asarray(x))), rtol=0, atol=2e-7)


def test_rows_and_nchw_entries_agree():
    kw = dict(in_planes=64, out_planes=32, k=1, padding=0, groupsici=4)
    _, _, _, block = _block(kw, seed=5)
    params = FB.block_tt_pointwise_params(block)
    x = torch.from_numpy(_bits((2, 4, 6, 64), 6))
    nchw = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        rows = FB.fused_pointwise_block(x.reshape(-1, 64), *params)
        got = FB.fused_pointwise_nchw(nchw, params, "heaviside")
    assert got.is_contiguous()
    assert torch.equal(got.permute(0, 2, 3, 1).reshape(-1, 32), rows)
    assert torch.equal(
        FB.fused_pointwise_block_v2_plain(x.reshape(-1, 64), *params), rows)


def test_plain_version_checks_its_arguments():
    kw = dict(in_planes=64, out_planes=32, k=1, padding=0, groupsici=4)
    _, _, _, block = _block(kw, seed=5)
    params = FB.block_tt_pointwise_params(block)
    x = torch.zeros((3, 64))
    with pytest.raises(ValueError, match="channels"):
        FB.fused_pointwise_block(x[:, :32], *params)
    with pytest.raises(ValueError, match="act"):
        FB.fused_pointwise_block(x, *params, act="identity")
    with pytest.raises(ValueError, match="k=1"):
        FB.fused_block_tt_pointwise(
            _block(dict(in_planes=4, out_planes=4, k=2, padding=1))[3],
            torch.zeros((1, 3, 3, 4)))


@pytest.fixture
def fused_on():
    saved = config.performance.fused_pointwise_blocks
    config.performance.fused_pointwise_blocks = True
    try:
        yield
    finally:
        config.performance.fused_pointwise_blocks = saved


def test_gate_takes_the_plain_version_on_the_cpu(fused_on, monkeypatch):
    """Switch on: a k=1 stride-1 block goes to ``fused_pointwise_nchw``
    (which, for a CPU tensor, runs the plain version); a k=4 head does
    not; the launch count does not move on the CPU."""
    calls = []
    real = block_mod.fused_pointwise_nchw
    monkeypatch.setattr(block_mod, "fused_pointwise_nchw",
                        lambda *a: calls.append(a) or real(*a))
    FB.reset_launches()
    point = _block(dict(in_planes=64, out_planes=32, k=1, padding=0,
                        groupsici=4), seed=7)[3]
    head = _block(dict(in_planes=4, out_planes=4, k=4, padding=2,
                       stride=2), seed=8)[3]
    x = torch.from_numpy(_bits((2, 5, 5, 64), 9)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = point(x)
        head(x[:, :4])
    assert len(calls) == 1 and calls[0][2] == "heaviside"
    want = FB.fused_pointwise_nchw(x, FB.block_tt_pointwise_params(point),
                                   "heaviside")
    assert torch.equal(got, want)
    assert FB.fused_pointwise_block.launches == 0


def test_gate_folds_the_params_once(fused_on, monkeypatch):
    """The gate folds a block's BNs once and reuses the fold; weights or
    BN statistics written in place (``load_state_dict``, an in-place op)
    are folded again."""
    block = _block(dict(in_planes=64, out_planes=32, k=1, padding=0,
                        groupsici=4), seed=11)[3]
    real = block_mod.block_tt_pointwise_params
    folds = []
    monkeypatch.setattr(block_mod, "block_tt_pointwise_params",
                        lambda b: folds.append(b) or real(b))
    x = torch.from_numpy(_bits((2, 3, 3, 64), 12)).permute(0, 3, 1, 2)
    with torch.no_grad():
        first = block(x)
        assert torch.equal(block(x), first) and len(folds) == 1
        sd = block.state_dict()
        sd["bn2.running_mean"] = sd["bn2.running_mean"] + 0.5
        block.load_state_dict(sd)
        block(x)
        assert len(folds) == 2
        block.bn1.running_var.mul_(2.0)
        got = block(x)
        assert len(folds) == 3
    for a, b in zip(block.pointwise_params(), real(block)):
        assert torch.equal(a, b)
    # W1 is kept in the kernel's (G, m, ci) rows: a launch copies nothing
    assert block.pointwise_params()[0].transpose(1, 2).is_contiguous()
    assert torch.equal(got, FB.fused_pointwise_nchw(x, real(block),
                                                    "heaviside"))


def test_truth_tables_do_not_depend_on_the_switch(monkeypatch):
    _, _, _, block = _block(dict(in_planes=16, out_planes=16, k=1,
                                 padding=0, groupsici=2), seed=10)
    off = block_truth_table(block)
    monkeypatch.setattr(config.performance, "fused_pointwise_blocks", True)
    monkeypatch.setattr(block_mod, "fused_pointwise_nchw",
                        lambda *a: pytest.fail("the table compiler ran the "
                                               "fused block"))
    assert torch.equal(block_truth_table(block), off)
    assert config.performance.fused_pointwise_blocks


def test_exact_numerics_restores_the_switch_after_an_exception():
    saved = config.performance.fused_pointwise_blocks
    try:
        config.performance.fused_pointwise_blocks = True
        with pytest.raises(RuntimeError):
            with config.exact_numerics():
                assert not config.performance.fused_pointwise_blocks
                raise RuntimeError("boom")
        assert config.performance.fused_pointwise_blocks
    finally:
        config.performance.fused_pointwise_blocks = saved


def test_small_model_with_the_switch_on(fused_on):
    """A small flagship-shaped model (p = 4, three blocks) with the switch
    on against off, in f32: top-1 agreement >= 99 % and, with every block
    fed the same input, at most 1e-3 of a block's output bits flipped (the
    polynomial erf is within 1.5e-6 of erf, so a bit flips only where a
    pre-activation sits that close to 0)."""
    _, _, _, md, model = jax_and_port("ttnet_imagenet_small", np.float32,
                                      nfilter=2, tfilter=2, layers=1)
    x = torch.from_numpy(images((16, 224, 224, 3), 12).astype(np.float32))
    with torch.no_grad():
        on = ttnet_imagenet_apply(model, x)
        h = stem(model, _nchw(x, model))
        shares = []
        for block in model.blocks:
            fused = block(h)
            with config.exact_numerics():
                exact = block(h)
            if block.cfg.last:
                assert float((fused - exact).abs().max()) < 1e-4
            else:
                shares.append(float((fused != exact).float().mean()))
            h = exact
        with config.exact_numerics():
            off = ttnet_imagenet_apply(model, x)
    assert float((on.argmax(1) == off.argmax(1)).float().mean()) >= 0.99
    assert len(shares) == 2 and max(shares) <= 1e-3
