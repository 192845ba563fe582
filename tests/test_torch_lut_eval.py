"""The port's truth tables and compiled-LUT forward.

Tables are enumerated in f64 on both sides and must be equal.  The port's
LUT logits are held against its conv logits to 1e-4 (the blocks are
bit-exact; only the float classifier sums in another order), as
``tests/test_lut_eval.py`` holds the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_from_jax, images, jax_and_port, \
    x64  # noqa: F401

from scale_imagenet_tpu.compile import lut_eval as jlut
from scale_imagenet_tpu.compile.truth_table import enumerate_patterns as \
    jenumerate
from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg, \
    block_tt as jblock_tt
from scale_imagenet_tpu_torch.compile import lut_eval
from scale_imagenet_tpu_torch.compile.truth_table import block_truth_table, \
    enumerate_patterns
from scale_imagenet_tpu_torch.kernels import lut_gather as K
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.block_tt import BlockTTConfig
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    ttnet_imagenet_apply

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

TABLE_CFGS = [
    dict(in_planes=1, out_planes=8, k=4, padding=2, stride=2,
         groupsici=1),                                  # n=16, k=4 head
    dict(in_planes=16, out_planes=8, k=1, padding=0, groupsici=1),  # n=16
    dict(in_planes=16, out_planes=16, k=1, padding=0, groupsici=4),  # n=4
    dict(in_planes=8, out_planes=8, k=2, padding=1, stride=2,
         groupsici=4),                                  # n=8, k=2
    dict(in_planes=16, out_planes=16, k=1, padding=0, groupsici=2,
         last=True),                                    # n=8 float table
]


def _block(kw, seed):
    return block_from_jax(kw, seed, np.float64)


@pytest.mark.parametrize("i", range(len(TABLE_CFGS)))
def test_truth_table_matches_jax(x64, i):
    kw = TABLE_CFGS[i]
    jcfg = JBlockCfg(**kw)
    pats = jenumerate(jcfg)
    np.testing.assert_array_equal(
        enumerate_patterns(BlockTTConfig(**kw)).numpy(), pats)
    p, s, block = _block(kw, i)
    y, _ = jblock_tt(jax.tree.map(jnp.asarray, p),
                     jax.tree.map(jnp.asarray, s), jcfg,
                     jnp.asarray(pats, jnp.float64), pre_padded=True)
    ref = np.asarray(y).reshape(pats.shape[0], -1, y.shape[-1])[:, 0, :]
    got = block_truth_table(block, chunk=20000).numpy()
    if kw.get("last"):
        # a float (ReLU) table: f64 values, summed in another order
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.mean() < 1                   # a non-trivial table
    kh, kw_ = (kw["k"], kw["k"]) if isinstance(kw["k"], int) else kw["k"]
    g = kw["groupsici"]
    np.testing.assert_array_equal(
        K.index_weights(kh, kw_, kw["in_planes"] // g, g).numpy(),
        np.transpose(np.asarray(jlut._index_weights(jcfg)), (3, 2, 0, 1)))


@pytest.mark.parametrize("i", range(len(TABLE_CFGS)))
def test_block_lut_matches_block(i):
    """Compiled block == float block on random bits (f32 tables)."""
    kw = TABLE_CFGS[i]
    _, _, block = _block(kw, i)
    block = block.float()
    lut = lut_eval.compile_block_tt_lut(block)
    x = torch.from_numpy(
        (images((2, 11, 11, kw["in_planes"]), i) < 0.5).astype(np.float32))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = block(x)
    got = lut_eval.lut_block_tt_apply(lut, x)
    if kw.get("last"):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, ref)


def _lut_model(name, layers=0):
    return jax_and_port(name, np.float32, nfilter=4, tfilter=4,
                        layers=layers)


def _port_model(name, layers=0):
    """The port alone: seeded init, BN statistics perturbed with numpy."""
    model = get_model(name, nfilter=4, tfilter=4, layers=layers).init(
        seed=0, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                noise = rng.standard_normal((2, m.num_features)) * 0.05
                m.running_mean.add_(torch.from_numpy(noise[0]).float())
                m.running_var.mul_(torch.from_numpy(np.exp(noise[1])).float())
    return model


@pytest.fixture(scope="module")
def compiled():
    """``{name: (model, luts)}``, each model compiled once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            model = _port_model(name)
            cache[name] = model, lut_eval.compile_ttnet_lut(model)
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["ttnet_imagenet_xsmall",
                                  "ttnet_imagenet_small"])
def test_lut_forward_matches_conv(compiled, name):
    model, luts = compiled(name)
    x = torch.from_numpy(images((2, 224, 224, 3), 5).astype(np.float32))
    with torch.no_grad():
        ref = ttnet_imagenet_apply(model, x)
    got = lut_eval.lut_ttnet_apply(luts, model, x)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    # the bf16 bit flow (the card's default) is bit-exact
    got_bf16 = lut_eval.lut_ttnet_apply(luts, model, x,
                                        bits_dtype=torch.bfloat16)
    assert torch.equal(got_bf16, got)
    # the table-exact variant serves the last fuse head from its float
    # table through the float gather
    got_tab = lut_eval.lut_ttnet_apply(luts, model, x, last_via_conv=False)
    torch.testing.assert_close(got_tab, got, rtol=1e-4, atol=1e-4)


def test_lut_forward_matches_jax_lut():
    """Port tables and LUT logits against the JAX LUT forward from the
    same weights."""
    jm, params, state, _, model = _lut_model("ttnet_imagenet_xsmall")
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    jluts = jlut.compile_ttnet_lut(jp, js, jm.config)
    luts = lut_eval.compile_ttnet_lut(model)
    for jl, tl in zip(jluts, luts):
        for i, h in tl.heads.items():
            np.testing.assert_array_equal(
                h.packed.numpy(),
                np.asarray(jl.heads[i].packed).reshape(h.packed.shape))
        if tl.convf.cfg.last:        # (G, 2^n, F) of the JAX table
            np.testing.assert_allclose(
                tl.convf.packed.numpy(),
                K.pack_float_table(np.array(jl.convf.table).T,
                                   tl.convf.cfg.groupsici).numpy(),
                rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(
                tl.convf.packed.numpy(),
                np.asarray(jl.convf.packed).reshape(tl.convf.packed.shape))
    x = images((2, 224, 224, 3), 6).astype(np.float32)
    ref = jlut.lut_ttnet_apply(jluts, jp, js, jm.config, jnp.asarray(x))
    got = lut_eval.lut_ttnet_apply(luts, model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert K.lut_window_bits.launches == 0          # CPU: no kernel


def test_merged_heads_use_one_gather(compiled, monkeypatch):
    """Heads 1+2 share one window launch on words concatenated once, when
    the LUTs are built; per block: merged heads, head 3, the fuse head (the
    last block's runs as the float conv)."""
    model, luts = compiled("ttnet_imagenet_small")
    calls = []
    real = lut_eval.lut_window_bits

    def rec(x, words, k, stride, padding, heads=1):
        calls.append((words, heads))
        return real(x, words, k, stride, padding, heads)

    monkeypatch.setattr(lut_eval, "lut_window_bits", rec)
    x = torch.from_numpy(images((1, 224, 224, 3), 8).astype(np.float32))
    lut_eval.lut_ttnet_apply(luts, model, x)
    first = [w for w, _ in calls]
    lut_eval.lut_ttnet_apply(luts, model, x)
    assert len(calls) == 2 * (3 + 2)            # 3 + 3 + 2 at --layers 1
    p = 16
    words, heads = calls[0]
    assert heads == 2 and tuple(words.shape) == (2 * p, 1, 2048)
    # the merged words are the block's, built once: the same tensor on
    # every forward, and each head's table a view of it
    assert words is luts[0].merged[0][1] and words is calls[5][0]
    assert all(a is b for a, (b, _) in zip(first, calls[5:]))
    h1, h2 = luts[0].heads[1].packed, luts[0].heads[2].packed
    assert h1.data_ptr() == words.data_ptr()
    assert h2.data_ptr() == words[p:].data_ptr()
    assert all(lut.heads[1].nonconstant > 0 for lut in luts)
