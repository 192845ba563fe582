"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips where there is none.  The file
imports nothing of JAX, so it also runs where JAX is not installed, with the
repo's ``conftest.py`` (which configures JAX) left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bits and gathered floats are exact: the window kernels and their plain
versions (which compute the index with a conv) must be equal.
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


def _bits(shape, channels_last, dtype, seed, device):
    """Seeded {0,1} bits (B, C, H, W), NCHW-contiguous or channels-last."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand(shape, generator=gen) < 0.5).to(dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    return x.to(device)


def _words(n, tables, f, seed, device):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randint(0, 2, (2 ** n, tables * f), generator=gen).float()
    return K.pack_bit_table(table, tables).to(device)


# the flagship's eight bit launches at B = 256, as (B, C, H, W) of the
# input, k, stride, padding, G, F, heads, channels-last input
FLAGSHIP_BITS = [
    ((256, 64, 56, 56), 4, 2, 2, 64, 1, 2, False),     # block 0 heads 1+2
    ((256, 64, 56, 56), 1, 1, 0, 4, 16, 1, False),     # block 0 head 3
    ((256, 256, 29, 29), 1, 1, 0, 16, 8, 1, False),    # block 0 fuse
    ((256, 128, 29, 29), 4, 2, 2, 128, 1, 2, True),    # block 1 heads 1+2
    ((256, 128, 29, 29), 1, 1, 0, 8, 16, 1, True),     # block 1 head 3
    ((256, 512, 15, 15), 1, 1, 0, 32, 8, 1, False),    # block 1 fuse
    ((256, 256, 15, 15), 4, 2, 2, 256, 1, 2, True),    # block 2 heads 1+2
    ((256, 256, 15, 15), 1, 1, 0, 16, 16, 1, True),    # block 2 head 3
]
# padded borders, odd H/W, n = 4, 8, 9, 16, 18 (tables beyond the
# shared-memory budget) and 24, F with and without 16-byte stores
SMALL_BITS = [
    ((2, 6, 7, 9), (2, 2), 1, 1, 6, 1, 1, False),      # n = 4
    ((3, 8, 13, 11), 2, 2, 1, 4, 3, 2, True),          # n = 8
    ((2, 4, 9, 7), 3, 1, 1, 4, 16, 1, False),          # n = 9
    ((2, 3, 11, 13), 4, 2, 2, 3, 1, 2, True),          # n = 16
    ((2, 32, 5, 7), 1, 1, 0, 2, 8, 2, False),          # n = 16
    ((1, 4, 6, 5), 3, 1, 1, 2, 8, 1, True),            # n = 18
    ((1, 6, 5, 6), 2, 2, 0, 1, 1, 1, False),           # n = 24
    # channels-last with whole 16-byte channel vectors a position
    ((2, 16, 5, 7), (1, 2), 1, 0, 2, 4, 1, True),      # n = 16
    ((1, 48, 3, 5), 1, 1, 0, 2, 1, 1, True),           # n = 24
    # one-channel groups read 8 (bf16) or 4 (f32) to a vector
    ((2, 16, 9, 7), 4, 2, 2, 16, 1, 2, True),          # n = 16
    # NCHW bits whose rows are whole 16-byte vectors
    ((2, 16, 13, 24), 4, 2, 2, 16, 1, 2, False),       # n = 16
    ((3, 32, 5, 16), 1, 1, 0, 2, 16, 1, False),        # n = 16
    ((2, 8, 7, 8), 3, 1, 1, 4, 2, 1, False),           # n = 18
]


def _bits_case(cuda, shape, k, stride, padding, g, f, heads, cl, seed):
    kh, kw = k if isinstance(k, tuple) else (k, k)
    n = kh * kw * shape[1] // g
    words = _words(n, heads * g, f, seed, cuda)
    before = K.lut_window_bits.launches
    for dt in (torch.bfloat16, torch.float32):
        x = _bits(shape, cl, dt, seed + 1, cuda)
        got = K.lut_window_bits(x, words, k, stride, padding, heads)
        torch.cuda.synchronize()
        want = K.lut_window_bits_plain(x, words, k, stride, padding, heads)
        assert got.dtype == dt and got.shape == want.shape
        assert torch.equal(got, want)
        # the layout is read through strides: the other one agrees too
        other = x.contiguous() if cl else x.to(
            memory_format=torch.channels_last)
        assert torch.equal(
            K.lut_window_bits(other, words, k, stride, padding, heads), got)
    assert K.lut_window_bits.launches == before + 4


@pytest.mark.parametrize("case", FLAGSHIP_BITS + SMALL_BITS,
                         ids=lambda c: f"{c[0]}-k{c[1]}s{c[2]}p{c[3]}"
                                       f"G{c[4]}F{c[5]}K{c[6]}")
def test_bit_kernel_matches_plain_on_card(cuda, case):
    _bits_case(cuda, *case, seed=sum(case[0]))


# the flagship's table-exact float launch (block 2's fuse head), and small
# ones with odd sizes, padding and F without 16-byte stores
FLOAT_CASES = [
    ((256, 1024, 8, 8), 1, 1, 0, 64, 16, False),
    ((2, 6, 7, 9), 2, 2, 1, 3, 5, True),
    ((3, 8, 9, 5), 3, 1, 1, 4, 4, False),
    ((2, 8, 5, 7), 1, 1, 1, 4, 4, False),              # pointwise, padded
]


@pytest.mark.parametrize("case", FLOAT_CASES, ids=lambda c: str(c[0]))
def test_float_kernel_matches_plain_on_card(cuda, case):
    shape, k, stride, padding, g, f, cl = case
    n = k * k * shape[1] // g
    gen = torch.Generator().manual_seed(n)
    table = K.pack_float_table(torch.randn((2 ** n, g * f), generator=gen),
                               g).to(cuda)
    before = K.lut_window_float.launches
    for dt in (torch.bfloat16, torch.float32):
        x = _bits(shape, cl, dt, n + 1, cuda)
        got = K.lut_window_float(x, table, k, stride, padding)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert torch.equal(got, K.lut_window_float_plain(x, table, k, stride,
                                                         padding))
    assert K.lut_window_float.launches == before + 2


def test_wrapper_refuses_mixed_devices(cuda):
    """Mixed devices, wrong dtypes, and a window or table that does not
    fit are refused before any launch."""
    x = _bits((1, 4, 5, 5), False, torch.bfloat16, 0, cuda)
    words = _words(4, 4, 2, 0, "cpu")
    before = K.lut_window_bits.launches
    with pytest.raises(ValueError, match="cpu"):
        K.lut_window_bits(x, words, 2, 1, 0)
    words = words.to(cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        K.lut_window_bits(x.to(torch.uint8), words, 2, 1, 0)
    with pytest.raises(TypeError, match="int32"):
        K.lut_window_bits(x, words.float(), 2, 1, 0)
    with pytest.raises(ValueError, match="bits"):
        K.lut_window_bits(_bits((1, 28, 5, 5), False, torch.bfloat16, 0,
                                cuda), words, 2, 1, 0)
    with pytest.raises(ValueError, match="entries"):
        K.lut_window_bits(x, words, 4, 1, 2)
    with pytest.raises(ValueError, match="fits"):
        K.lut_window_bits(x, words, 2, 1, -3)
    table = K.pack_float_table(torch.randn((16, 8)), 4).to(cuda)
    with pytest.raises(ValueError, match="entries"):
        K.lut_window_float(x, table, 1, 1, 0)
    with pytest.raises(ValueError, match="cpu"):
        K.lut_window_float(x, table.cpu(), 2, 1, 0)
    assert K.lut_window_bits.launches == before


def test_flagship_lut_forward_through_the_kernel(cuda, monkeypatch):
    """The flagship served as tables on the card: 8 bit launches a forward,
    1 float launch in the table-exact one, logits equal to the plain
    versions', top-1 equal to the conv forward's."""
    model = get_model("ttnet_imagenet_small").init(seed=0, device=cuda)
    luts = lut_eval.compile_ttnet_lut(model)
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(1)).to(cuda)
    K.reset_launches()
    got = lut_eval.lut_ttnet_apply(luts, model, x)
    got_tab = lut_eval.lut_ttnet_apply(luts, model, x, last_via_conv=False)
    torch.cuda.synchronize()
    assert (K.lut_window_bits.launches, K.lut_window_float.launches) == \
        (16, 1)
    ref = ttnet_imagenet_apply(model, x)
    assert torch.equal(got.argmax(1), ref.argmax(1))
    monkeypatch.setattr(lut_eval, "lut_window_bits", K.lut_window_bits_plain)
    monkeypatch.setattr(lut_eval, "lut_window_float",
                        K.lut_window_float_plain)
    assert torch.equal(lut_eval.lut_ttnet_apply(luts, model, x), got)
    assert torch.equal(lut_eval.lut_ttnet_apply(
        luts, model, x, last_via_conv=False), got_tab)


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


def test_flagship_train_step_on_card_matches_cpu(cuda):
    """One f32 train step of the flagship (B = 32, no augmentation) on the
    card, with the fused switch on, and on the CPU from the same weights
    and batch: no fused launch (training keeps the unfused chain), the
    relative loss gap <= 1e-3, the cosine of the two parameter updates >=
    0.99 and at most 1e-3 of the Heaviside outputs flipped (the limits of
    ``chip_smoke.py``'s train phase)."""
    import copy
    from unittest import mock

    from scale_imagenet_tpu_torch.models import block_tt, ttnet_imagenet
    from scale_imagenet_tpu_torch.ops import binarize
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model = get_model("ttnet_imagenet_small").init(seed=0, device=cuda)
    cpu_model = copy.deepcopy(model).cpu()
    start = [p.detach().cpu().clone() for p in model.parameters()]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((32, 224, 224, 3), generator=gen)
    y = torch.randint(0, 1000, (32,), generator=gen)
    real = binarize.heaviside01

    def step(net, xb, yb):
        bits = []

        def rec(t, *a, **k):
            out = real(t, *a, **k)
            bits.append((out.detach() > 0).cpu())
            return out

        opt, _ = make_optimizer(0.1)
        ts = TrainState(net, opt.init(dict(net.named_parameters())))
        with mock.patch.object(binarize, "heaviside01", rec), \
                mock.patch.object(block_tt, "heaviside01", rec), \
                mock.patch.object(ttnet_imagenet, "heaviside01", rec):
            _, metrics = make_train_step(net, opt)(ts, xb, yb)
        return float(metrics["loss"]), bits

    FB.reset_launches()
    with fused_on():
        card_loss, card_bits = step(model, x.to(cuda), y.to(cuda))
    assert FB.fused_pointwise_block.launches == 0
    cpu_loss, cpu_bits = step(cpu_model, x, y)
    assert abs(card_loss - cpu_loss) <= 1e-3 * abs(cpu_loss)
    du = torch.cat([(p.detach().cpu() - s).double().ravel()
                    for p, s in zip(model.parameters(), start)])
    dv = torch.cat([(p.detach() - s).double().ravel()
                    for p, s in zip(cpu_model.parameters(), start)])
    assert float(du @ dv / (du.norm() * dv.norm())) >= 0.99
    assert [b.shape for b in card_bits] == [b.shape for b in cpu_bits]
    flips = sum(int((a != b).sum()) for a, b in zip(card_bits, cpu_bits))
    assert flips <= 1e-3 * sum(b.numel() for b in cpu_bits)
