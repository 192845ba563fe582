"""The port's LUT window gathers against the JAX LUT forward of one block.

``lut_window_bits_plain`` / ``lut_window_float_plain`` (what the CUDA
window kernels are held against on the card) take the block's input bits
and its tables and return the NHWC activation.  The JAX side is
``compile/lut_eval.py``'s index conv feeding the Pallas gather in interpret
mode (``lut_block_tt_apply(pallas=True)`` and ``_merged_heads_apply``).
Both sides compile their tables from the same weights, carried across with
``convert/from_jax.py``; bit tables are equal, and a float table is the
JAX one, since the two compilers sum in another order.  Outputs are bits
or gathered table values: they must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_from_jax

from scale_imagenet_tpu.compile import lut_eval as jlut
from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg
from scale_imagenet_tpu_torch.compile import lut_eval
from scale_imagenet_tpu_torch.kernels import lut_gather as K

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

# (Block_TT config, heads sharing the index): the flagship's depthwise 4x4
# heads 1+2, its k=1 grouped head (n = 16), xsmall's k=2 p=1 heads 1+2,
# small_g8's k=1 head (n = 8), and a float (ReLU) fuse head; t = 2 keeps
# the n = 16 enumerations short
GEOMETRIES = {
    "depthwise_k4": (dict(in_planes=3, out_planes=3, k=4, padding=2,
                          stride=2, groupsici=3, t=2), 2),
    "grouped_k1_n16": (dict(in_planes=32, out_planes=8, k=1, padding=0,
                            groupsici=2, t=2), 1),
    "xsmall_k2_p1": (dict(in_planes=4, out_planes=4, k=2, padding=1,
                          stride=2, groupsici=4), 2),
    "small_g8_n8": (dict(in_planes=16, out_planes=16, k=1, padding=0,
                         groupsici=2), 1),
    "float_k1_n8": (dict(in_planes=16, out_planes=16, k=1, padding=0,
                         groupsici=2, last=True), 1),
}


@pytest.fixture(scope="module")
def compiled():
    """``{name: (jax luts, port luts)}``, each compiled once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, heads = GEOMETRIES[name]
            jl, tl = [], []
            for h in range(heads):
                p, s, block = block_from_jax(kw, 10 * h + len(name),
                                             np.float32)
                jl.append(jlut.compile_block_tt_lut(p, s, JBlockCfg(**kw)))
                tl.append(lut_eval.compile_block_tt_lut(block))
            cache[name] = jl, tl
        return cache[name]
    return get


def _bits(shape, seed, dtype, channels_last):
    """Seeded {0,1} bits: the port's NCHW tensor and the JAX NHWC array."""
    b = (np.random.default_rng(seed).uniform(size=shape) < 0.5).astype(
        np.float32)                                        # NHWC
    x = torch.from_numpy(b).permute(0, 3, 1, 2).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last if channels_last
                     else torch.contiguous_format)
    return x, jnp.asarray(b, jnp.bfloat16 if dtype == torch.bfloat16
                          else jnp.float32)


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_window_plain_matches_jax_lut(compiled, name, dtype, channels_last):
    kw, heads = GEOMETRIES[name]
    jl, tl = compiled(name)
    x, xj = _bits((2, 7, 9, kw["in_planes"]), len(name), dtype,
                  channels_last)
    b = x.shape[0]
    if kw.get("last"):
        ref = jlut.lut_block_tt_apply(jl[0], xj, pallas=True,
                                      interpret=True)
        table = K.pack_float_table(np.array(jl[0].table).T,
                                   kw["groupsici"])
        np.testing.assert_allclose(table.numpy(), tl[0].packed.numpy(),
                                   rtol=0, atol=1e-6)
        got = K.lut_window_float_plain(x, table, kw["k"], 1, 0)
        assert got.dtype == torch.float32
    else:
        if heads > 1:
            ref = jnp.concatenate(jlut._merged_heads_apply(
                jl, xj, interpret=True), axis=-1)
        else:
            ref = jlut.lut_block_tt_apply(jl[0], xj, pallas=True,
                                          interpret=True)
        for j, t in zip(jl, tl):                          # equal tables
            np.testing.assert_array_equal(
                t.packed.numpy(), np.asarray(j.packed).reshape(
                    t.packed.shape))
        words = torch.cat([t.packed for t in tl])
        got = K.lut_window_bits_plain(x, words, kw["k"], kw.get("stride", 1),
                                      kw["padding"], heads=heads)
        assert got.dtype == dtype
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.reshape(-1, ref.shape[-1]))
    assert got.shape[0] == b * ref.shape[1] * ref.shape[2]


@pytest.mark.parametrize("name", ["depthwise_k4", "grouped_k1_n16"])
def test_window_index_matches_truth_table_order(compiled, name):
    """The plain index is the row of the table a window reads: a window
    holding pattern row v of ``enumerate_patterns`` gets index v."""
    from scale_imagenet_tpu_torch.compile.truth_table import \
        enumerate_patterns

    kw, _ = GEOMETRIES[name]
    _, tl = compiled(name)
    pats = enumerate_patterns(tl[0].cfg)      # (2^n, kh, kw, in_planes)
    rows = torch.arange(0, pats.shape[0], 4099)
    x = pats[rows].permute(0, 3, 1, 2)        # every group's window alike
    g = kw["groupsici"]
    idx = K.window_index_plain(x, g, kw["k"], 1, 0)
    assert torch.equal(idx, rows.to(torch.int32).view(-1, 1).expand(-1, g))


def test_window_wrappers_on_cpu_are_the_plain_versions(compiled):
    kw, heads = GEOMETRIES["depthwise_k4"]
    _, tl = compiled("depthwise_k4")
    words = torch.cat([t.packed for t in tl])
    x, _ = _bits((1, 5, 6, 3), 3, torch.bfloat16, True)
    before = (K.lut_window_bits.launches, K.lut_window_float.launches)
    assert torch.equal(K.lut_window_bits(x, words, 4, 2, 2, heads),
                       K.lut_window_bits_plain(x, words, 4, 2, 2, heads))
    table = K.pack_float_table(np.ones((2, 6), np.float32), 3)
    assert torch.equal(K.lut_window_float(x, table, 1, 1, 0),
                       K.lut_window_float_plain(x, table, 1, 1, 0))
    assert (K.lut_window_bits.launches, K.lut_window_float.launches) == \
        before
