"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips where there is none.  The file
imports nothing of JAX, so it also runs where JAX is not installed, with the
repo's ``conftest.py`` (which configures JAX) left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bits and gathered floats are exact: kernel and plain version must be equal.
The fused pointwise block sums in another order than the plain version
and contracts multiply-adds: ReLU outputs agree to 1e-5 (f32), and a
Heaviside bit may flip only where the plain pre-activation is within 1e-4
of the threshold, in at most 1e-4 of the outputs.
"""

import pytest
import torch

import contextlib

from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch.compile import lut_eval
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.kernels import lut_gather as K
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    ttnet_imagenet_apply

pytestmark = pytest.mark.gpu


@contextlib.contextmanager
def fused_on():
    saved = config.performance.fused_pointwise_blocks
    config.performance.fused_pointwise_blocks = True
    try:
        yield
    finally:
        config.performance.fused_pointwise_blocks = saved


@pytest.fixture
def cuda():
    """The card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


# (G, F, E) of the flagship's eight bit-gather launches at B = 256, and a
# ragged shape whose F takes the kernel's scalar store path
FLAGSHIP_BITS = [(128, 1, 215296), (4, 16, 802816), (16, 8, 215296),
                 (256, 1, 57600), (8, 16, 215296), (32, 8, 57600),
                 (512, 1, 16384), (16, 16, 57600), (3, 5, 1001)]


@pytest.mark.parametrize("g,f,e", FLAGSHIP_BITS)
def test_bit_kernel_matches_plain_on_card(cuda, g, f, e):
    gen = torch.Generator().manual_seed(g * f)
    table = torch.randint(0, 2, (2 ** 16, g * f), generator=gen).float()
    words = K.pack_bit_table(table, g).to(cuda)
    idx = torch.randint(0, 2 ** 16, (e, g), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = K.lut_gather_bits.launches
    for dt in (torch.bfloat16, torch.float32):
        got = K.lut_gather_bits(words, idx, dt)
        torch.cuda.synchronize()
        assert torch.equal(got, K.lut_gather_bits_plain(words, idx, dt))
    assert K.lut_gather_bits.launches == before + 2


@pytest.mark.parametrize("n,g,f,e", [(16, 64, 16, 16384), (4, 3, 5, 77),
                                     (20, 2, 4, 5000)])
def test_float_kernel_matches_plain_on_card(cuda, n, g, f, e):
    gen = torch.Generator().manual_seed(n)
    table = torch.randn((g, f, 2 ** n), generator=gen).to(cuda)
    idx = torch.randint(0, 2 ** n, (e, g), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = K.lut_gather_float.launches
    got = K.lut_gather_float(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.lut_gather_float_plain(table, idx))
    assert K.lut_gather_float.launches == before + 1


def test_wrapper_refuses_mixed_devices(cuda):
    words = K.pack_bit_table(torch.ones((64, 4)), 2)
    idx = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        K.lut_gather_bits(words, idx)


def test_flagship_lut_forward_through_the_kernel(cuda, monkeypatch):
    """The flagship served as tables on the card: 8 bit-gather launches a
    forward, logits equal to the plain gather's, top-1 equal to the conv
    forward's."""
    model = get_model("ttnet_imagenet_small").init(seed=0, device=cuda)
    luts = lut_eval.compile_ttnet_lut(model)
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(1)).to(cuda)
    K.reset_launches()
    got = lut_eval.lut_ttnet_apply(luts, model, x)
    torch.cuda.synchronize()
    assert K.lut_gather_bits.launches == 8
    ref = ttnet_imagenet_apply(model, x)
    assert torch.equal(got.argmax(1), ref.argmax(1))
    monkeypatch.setattr(lut_eval, "lut_gather_bits", K.lut_gather_bits_plain)
    monkeypatch.setattr(lut_eval, "lut_gather_float",
                        K.lut_gather_float_plain)
    assert torch.equal(lut_eval.lut_ttnet_apply(luts, model, x), got)


# ---------------------------------------------------- fused pointwise block

def _fused_inputs(g, ci, m, co, n, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((n, g * ci), generator=gen) < 0.5).to(dtype)
    w1 = torch.randn((g, ci, m), generator=gen) / ci ** 0.5
    w2 = torch.randn((g, m, co), generator=gen) / m ** 0.5
    s1, s2 = 1 + 0.1 * torch.randn((g, m), generator=gen), \
        1 + 0.1 * torch.randn((g, co), generator=gen)
    b1, b2 = 0.3 * torch.randn((g, m), generator=gen), \
        0.3 * torch.randn((g, co), generator=gen)
    return [t.to(device) for t in (x, w1, s1, b1, w2, s2, b2)]


# (G, ci, m, co, N): flagship launches cut to a few thousand pixels, the
# xsmall / small_g8 shapes, and a ragged N
FUSED_SHAPES = [(4, 16, 128, 16, 5000), (16, 16, 128, 8, 3001),
                (64, 16, 128, 16, 1024), (8, 4, 32, 2, 777),
                (4, 8, 64, 8, 513), (3, 2, 16, 1, 100)]


@pytest.mark.parametrize("g,ci,m,co,n", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["heaviside", "relu"])
def test_fused_kernel_matches_plain_on_card(cuda, g, ci, m, co, n, dtype,
                                            act):
    args = _fused_inputs(g, ci, m, co, n, dtype, g * ci + co, cuda)
    before = FB.fused_pointwise_block.launches
    got = FB.fused_pointwise_block(*args, act=act)
    torch.cuda.synchronize()
    assert FB.fused_pointwise_block.launches == before + 1
    want = FB.fused_pointwise_block_plain(*args, act=act)
    assert got.dtype == dtype and got.shape == want.shape
    if act == "relu":
        # f32 compute: FMA contraction and summation order move the last
        # bits; bf16 output rounds them to bf16 steps
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    else:
        flips = got != want
        assert flips.float().mean() <= 1e-4
        pre = FB.fused_pointwise_preact_plain(*args)
        assert bool((pre[flips].abs() < 1e-4).all())


def test_fused_kernel_reads_nchw_through_strides(cuda):
    """The NCHW entry (contiguous and channels-last) equals the row
    contract on the same pixels, and so does W1 in either layout."""
    x, *params = _fused_inputs(4, 16, 128, 16, 2 * 7 * 9, torch.float32, 5,
                               cuda)
    nchw = x.reshape(2, 7, 9, 64).permute(0, 3, 1, 2)
    rows = FB.fused_pointwise_block(x, *params, act="relu")
    for view in (nchw, nchw.contiguous()):
        got = FB.fused_pointwise_nchw(view, tuple(params), "relu")
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.permute(0, 2, 3, 1).reshape(-1, 64), rows, rtol=0, atol=0)
    # W1 as the model folds it: a (ci, m) view of (m, ci) rows
    w1 = params[0].transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(
        FB.fused_pointwise_block(x, w1, *params[1:], act="relu"), rows,
        rtol=0, atol=0)


def test_fused_wrapper_refuses_mixed_devices_and_shapes(cuda):
    x, *params = _fused_inputs(4, 16, 128, 16, 64, torch.float32, 1, cuda)
    with pytest.raises(ValueError, match="cpu"):
        FB.fused_pointwise_block(x, *[p.cpu() for p in params])
    x3, *p3 = _fused_inputs(2, 3, 24, 3, 64, torch.float32, 2, cuda)
    with pytest.raises(ValueError, match="covers"):
        FB.fused_pointwise_block(x3, *p3)
    with pytest.raises(ValueError, match="channels"):
        FB.fused_pointwise_block(x[:, :32], *params)


def test_flagship_conv_forward_through_the_fused_kernel(cuda):
    """With the switch on, a flagship conv forward launches the fused
    kernel 6 times (head 3 and the fuse head of 3 blocks) and keeps the
    argmax of the unfused forward."""
    model = get_model("ttnet_imagenet_small").init(seed=0, device=cuda)
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(2)).to(cuda)
    ref = ttnet_imagenet_apply(model, x)
    FB.reset_launches()
    with fused_on():
        got = ttnet_imagenet_apply(model, x)
    torch.cuda.synchronize()
    assert FB.fused_pointwise_block.launches == 6
    assert torch.equal(got.argmax(1), ref.argmax(1))
