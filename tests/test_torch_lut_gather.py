"""The port's table packing and index-array gathers against the JAX Pallas
kernel (interpret mode), and the window wrappers on the CPU.

Packing and gather outputs are integers and bits: they must be equal.  The
index-array gathers are the second half of the window kernels' plain
versions (``tests/test_torch_lut_window.py`` holds those against the JAX
LUT forward); the CUDA window kernels are held against their plain
versions in ``tests/test_torch_cuda.py``, which skips where there is no
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scale_imagenet_tpu.pallas.lut_gather import lut_gather_nhwc, \
    pack_bit_table as jpack_bits, pack_float_table as jpack_float
from scale_imagenet_tpu_torch.kernels import lut_gather as K

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

CASES = [(4, 1, 3), (9, 4, 1), (16, 2, 16)]


def _bit_table(n, out, seed):
    return np.random.default_rng(seed).integers(0, 2, (2 ** n, out)).astype(
        np.float32)


def _idx(n, shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** n, shape).astype(
        np.int32)


@pytest.mark.parametrize("n,g,f", CASES + [(12, 3, 2)])
def test_pack_bit_table_matches_jax(n, g, f):
    table = _bit_table(n, g * f, n)
    words = K.pack_bit_table(torch.from_numpy(table), g)
    ref = jpack_bits(table, g)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), ref.reshape(g, f, -1))
    with pytest.raises(ValueError, match="non-binary"):
        K.pack_bit_table(torch.from_numpy(table) * 0.5, g)


def test_pack_float_table_layout():
    table = np.random.default_rng(1).standard_normal((2 ** 5, 6)).astype(
        np.float32)
    got = K.pack_float_table(torch.from_numpy(table), 2)
    ref = jpack_float(table, 2)                       # (G, F, S, 128) padded
    # filter-minor: (G, 2^n, F), the JAX layout's rows transposed
    np.testing.assert_array_equal(
        got.numpy(), ref.reshape(2, 3, -1)[:, :, :2 ** 5].transpose(0, 2, 1))


@pytest.mark.parametrize("n,g,f", CASES)
def test_plain_bit_gather_matches_pallas(n, g, f):
    table = _bit_table(n, g * f, n + g + f)
    idx = _idx(n, (2, 3, 5, g), n)
    ref = lut_gather_nhwc(jnp.asarray(jpack_bits(table, g)),
                          jnp.asarray(idx), tile_rows=8, interpret=True)
    words = K.pack_bit_table(torch.from_numpy(table), g)
    for dt in (torch.float32, torch.bfloat16):
        got = K.lut_gather_bits_plain(words,
                                      torch.from_numpy(idx.reshape(-1, g)),
                                      dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).reshape(-1, g * f))


@pytest.mark.parametrize("n,g,f", CASES)
def test_plain_float_gather_matches_pallas(n, g, f):
    table = np.random.default_rng(n).standard_normal(
        (2 ** n, g * f)).astype(np.float32)
    idx = _idx(n, (2, 3, 5, g), n + 1)
    ref = lut_gather_nhwc(jnp.asarray(jpack_float(table, g)),
                          jnp.asarray(idx), tile_rows=8, interpret=True)
    got = K.lut_gather_float_plain(K.pack_float_table(table, g),
                                   torch.from_numpy(idx.reshape(-1, g)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).reshape(-1, g * f))


def test_merged_heads_gather_matches_pallas():
    """Two heads' tables and indices concatenated along G: one gather
    equals the JAX kernel on the same concatenation, head-major."""
    n, g, f = 8, 4, 2
    tabs = [_bit_table(n, g * f, s) for s in (10, 11)]
    idxs = [_idx(n, (2, 3, 5, g), s) for s in (12, 13)]
    ref = lut_gather_nhwc(
        jnp.concatenate([jnp.asarray(jpack_bits(t, g)) for t in tabs]),
        jnp.asarray(np.concatenate(idxs, -1)), tile_rows=8, interpret=True)
    words = torch.cat([K.pack_bit_table(t, g) for t in tabs])
    idx = torch.from_numpy(np.concatenate(idxs, -1).reshape(-1, 2 * g))
    got = K.lut_gather_bits_plain(words, idx)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).reshape(-1, 2 * g * f))


def test_wrapper_on_cpu_is_the_plain_version():
    """On the CPU each window wrapper is its plain version, which is the
    index conv followed by the index-array gather; no launch is counted."""
    words = K.pack_bit_table(_bit_table(6, 8, 0), 4)    # 4 groups, n = 6
    x = torch.from_numpy(_idx(1, (2, 8, 5, 7), 1).astype(np.float32))
    table = K.pack_float_table(np.ones((64, 8), np.float32), 4)
    before = (K.lut_window_bits.launches, K.lut_window_float.launches)
    xb = x.to(torch.bfloat16)
    got = K.lut_window_bits(xb, words, (3, 1), 2, 1)    # ci = 2: n = 6
    assert torch.equal(got, K.lut_window_bits_plain(xb, words, (3, 1), 2,
                                                    1))
    idx = K.window_index_plain(x, 4, (3, 1), 2, 1)
    assert torch.equal(got, K.lut_gather_bits_plain(words, idx,
                                                    torch.bfloat16))
    assert torch.equal(K.lut_window_float(x, table, (3, 1), 2, 1),
                       K.lut_gather_float_plain(table, idx))
    # the counts are kernel launches: the plain version is not one
    assert (K.lut_window_bits.launches, K.lut_window_float.launches) == \
        before


def test_wrapper_checks():
    words = K.pack_bit_table(_bit_table(6, 8, 0), 4)
    x = torch.zeros((2, 8, 5, 7))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        K.lut_window_bits(x.long(), words, (3, 1))
    with pytest.raises(TypeError, match="int32"):
        K.lut_window_bits(x, words.float(), (3, 1))
    with pytest.raises(ValueError, match="channels"):
        K.lut_window_bits(x[:, :6], words, (3, 1))
    with pytest.raises(ValueError, match="heads"):
        K.lut_window_bits(x, words, (3, 1), heads=3)
    with pytest.raises(ValueError, match="contiguous"):
        K.lut_window_bits(x, words.transpose(1, 2), (3, 1))
    with pytest.raises(ValueError, match="bits"):           # n = 25
        K.lut_window_bits(torch.zeros((1, 100, 3, 3)), words, 1)
    with pytest.raises(ValueError, match="entries"):        # n = 13
        K.lut_window_bits(torch.zeros((1, 52, 3, 3)), words, 1)
    with pytest.raises(ValueError, match="fits"):
        K.lut_window_bits(x, words, (3, 1), 1, -2)
    with pytest.raises(ValueError, match="entries"):
        K.lut_window_float(x, K.pack_float_table(
            np.ones((32, 8), np.float32), 4), (3, 1))
    # the index-array contract keeps its own checks
    idx = torch.from_numpy(_idx(6, (50, 4), 1))
    with pytest.raises(IndexError):
        K.lut_gather_bits_plain(words, idx + 32 * words.shape[2])
    with pytest.raises(IndexError):
        K.lut_gather_float_plain(K.pack_float_table(
            np.ones((64, 8), np.float32), 4), idx + 64)
