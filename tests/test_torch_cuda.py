"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips where there is none.  The file
imports nothing of JAX, so it also runs where JAX is not installed, with the
repo's ``conftest.py`` (which configures JAX) left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bits and gathered floats are exact: the window kernels and their plain
versions (which compute the index with a conv) must be equal.
The fused pointwise block sums in another order than the plain version
and contracts multiply-adds, and its tensor-core body takes each group
product as three TF32 products (a split f32): ReLU outputs agree to 1e-5
(f32), and a Heaviside bit may flip only where the plain pre-activation is
within 1e-4 of the threshold, in at most 1e-4 of the outputs.  The cube evaluation
(``gate_cubes``) is integer logic: its words equal the plain version's.
"""

import pytest
import torch

import contextlib

from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch.compile import gate_device, gate_net, \
    lut_eval
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
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

def _fused_inputs(g, ci, m, co, n, dtype, seed, device, continuous=False):
    """Seeded inputs of one launch: x {0,1} bits, or, ``continuous``, a
    Gaussian (a pooled head's input may be fractional)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, g * ci), generator=gen).to(dtype) if continuous \
        else (torch.rand((n, g * ci), generator=gen) < 0.5).to(dtype)
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


def _fused_check(cuda, g, ci, m, co, n, dtype, act, continuous=False):
    """The kernel against its plain version on seeded inputs: ReLU to 1e-5
    (f32) or 1e-2 (bf16), Heaviside flips only near the threshold."""
    args = _fused_inputs(g, ci, m, co, n, dtype, g * ci + co, cuda,
                         continuous)
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


@pytest.mark.parametrize("g,ci,m,co,n", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["heaviside", "relu"])
def test_fused_kernel_matches_plain_on_card(cuda, g, ci, m, co, n, dtype,
                                            act):
    _fused_check(cuda, g, ci, m, co, n, dtype, act)


# the v2 variant's six k=1 launches at p = 64 as (G, ci, m, co, act), their
# pixels cut to a few thousand: head 3 and the fuse head of blocks 0, 1, 2
V2_FUSED = [(2, 32, 256, 32, "heaviside"), (8, 32, 256, 16, "heaviside"),
            (4, 32, 256, 32, "heaviside"), (16, 32, 256, 16, "heaviside"),
            (8, 32, 256, 32, "heaviside"), (32, 32, 256, 32, "relu")]


@pytest.mark.parametrize("case", V2_FUSED,
                         ids=lambda c: "G{}ci{}m{}co{}{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_kernel_matches_plain_on_v2_shapes(cuda, case, dtype):
    g, ci, m, co, act = case
    _fused_check(cuda, g, ci, m, co, 1000 + 333 * g, dtype, act)


# the TT_FHE family's k=1 launches at p = 64 and B = 256: the fhe_v3 head 3
# (16x16) and fuse head (17x17), and TT_FHE_XSMALL_vAlexnet's head 3 (10x10)
FHE_FUSED = [(16, 4, 32, 4, 256 * 16 * 16), (64, 4, 32, 4, 256 * 17 * 17),
             (8, 8, 64, 8, 256 * 10 * 10)]


@pytest.mark.parametrize("g,ci,m,co,n", FHE_FUSED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_kernel_matches_plain_on_fhe_shapes(cuda, g, ci, m, co, n,
                                                  dtype):
    _fused_check(cuda, g, ci, m, co, n, dtype, "heaviside")


# a flagship and a v2 shape on continuous x: the split's x_lo product
# runs on values that are not exact in TF32
CONTINUOUS_FUSED = [(4, 16, 128, 16, 5000), (2, 32, 256, 32, 3000)]


@pytest.mark.parametrize("g,ci,m,co,n", CONTINUOUS_FUSED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["heaviside", "relu"])
def test_fused_kernel_matches_plain_on_continuous_x(cuda, g, ci, m, co, n,
                                                    dtype, act):
    _fused_check(cuda, g, ci, m, co, n, dtype, act, continuous=True)


# every pair of the tensor-core body at a pixel count that ends inside a
# 16-pixel warp tile
RAGGED_TC = [(3, 8, 64, 8, 1001), (2, 16, 128, 8, 2003),
             (2, 16, 128, 16, 4099), (2, 32, 256, 16, 3005),
             (2, 32, 256, 32, 1337)]


@pytest.mark.parametrize("g,ci,m,co,n", RAGGED_TC)
@pytest.mark.parametrize("act", ["heaviside", "relu"])
def test_fused_tensor_core_pairs_on_ragged_pixels(cuda, g, ci, m, co, n,
                                                  act):
    assert FB.fused_body(ci, m, co) == "tensor_core"
    _fused_check(cuda, g, ci, m, co, n, torch.float32, act, continuous=True)


# one launch a body, as (G, ci, m, co, N): the tensor-core pairs, a
# tensor-core pair whose m is not a multiple of 16, and small pairs
FUSED_BODIES = [((4, 16, 128, 16, 700), "tensor_core"),
                ((2, 32, 256, 32, 700), "tensor_core"),
                ((8, 8, 64, 8, 700), "tensor_core"),
                ((4, 16, 40, 16, 700), "fma"),
                ((8, 8, 24, 8, 700), "fma"),
                ((16, 4, 32, 4, 700), "fma")]


@pytest.mark.parametrize("case,body", FUSED_BODIES,
                         ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else c)
def test_fused_launcher_picks_the_body_by_shape(cuda, case, body):
    """The body the C launcher takes for (ci, m, co), as its launch plan
    reports it, is the wrapper's ``fused_body``, and the launch matches
    plain; a pair neither body covers is refused."""
    g, ci, m, co, n = case
    assert FB.fused_body(ci, m, co) == body
    plan = FB.launch_plan(ci, m, co)
    assert plan["body"] == body
    assert (plan["ctas_per_sm"] > 0) == (body == "tensor_core")
    _fused_check(cuda, g, ci, m, co, n, torch.float32, "relu",
                 continuous=True)
    with pytest.raises(RuntimeError, match="plan"):
        FB.launch_plan(3, 24, 3)


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


# eval forwards: one that autograd records never takes the fused
# kernel, which has no backward (``models/block_tt.py``)
@torch.no_grad()
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
        # every model reaches it through ``binarize01_act``
        with mock.patch.object(binarize, "heaviside01", rec):
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


# ------------------------------------------------------------- gate_cubes

# the flagship's eleven cube launches of a B = 256 gate forward as (G, F,
# n, W): block 0 heads 1 and 2, head 3, fuse; block 1 the same; block 2
# heads 1 and 2, head 3 (its fuse head is float)
FLAGSHIP_GATES = [(64, 1, 16, 6728), (64, 1, 16, 6728), (4, 16, 16, 25088),
                  (16, 8, 16, 6728), (128, 1, 16, 1800), (128, 1, 16, 1800),
                  (8, 16, 16, 6728), (32, 8, 16, 1800), (256, 1, 16, 512),
                  (256, 1, 16, 512), (16, 16, 16, 1800)]
# n = 4 .. 16 and wider, word counts that end inside a block's tile and
# below one tile, one filter a group and many
SMALL_GATES = [(3, 2, 4, 7), (2, 5, 8, 1000), (1, 3, 9, 513),
               (4, 4, 12, 33), (2, 2, 16, 1), (1, 2, 20, 300),
               (2, 1, 24, 64)]


def _cubes(gf: int, n: int, t_max: int, seed: int):
    """Seeded covers of ``gf`` filters: filter 0 empty (a constant
    filter), filter 1 one cube, the others 1..t_max cubes whose masks
    leave about three quarters of the n bits fixed."""
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(1, t_max + 1, (gf,), generator=gen)
    counts[0] = 0
    if gf > 1:
        counts[1] = 1
    total = int(counts.sum())
    value = torch.randint(0, 2 ** n, (total,), generator=gen)
    mask = torch.zeros(total, dtype=torch.int64)
    for p in range(n):
        mask |= (torch.rand(total, generator=gen) < 0.25).long() << p
    cubes = torch.stack([value & ~mask, mask], 1).to(torch.int32)
    offsets = torch.zeros(gf + 1, dtype=torch.int64)
    offsets[1:] = counts.cumsum(0)
    return cubes, offsets


def _gate_case(cuda, g, f, n, w, t_max, seed):
    gen = torch.Generator().manual_seed(seed)
    planes = torch.randint(-2 ** 31, 2 ** 31, (g, n, w), generator=gen,
                           dtype=torch.int64).to(torch.int32)
    cubes, offsets = _cubes(g * f, n, t_max, seed + 1)
    args = [t.to(cuda) for t in (planes, cubes, offsets)]
    before = GC.gate_cubes.launches
    for invert in (False, True):
        got = GC.gate_cubes(*args, f, invert)
        torch.cuda.synchronize()
        want = GC.gate_cubes_plain(*args, f, invert)
        assert got.dtype == torch.int32 and got.shape == (g, f, w)
        assert torch.equal(got, want)
        assert (got[0, 0] == (-1 if invert else 0)).all()   # empty cover
    assert GC.gate_cubes.launches == before + 2


@pytest.mark.parametrize("case", FLAGSHIP_GATES,
                         ids=lambda c: "G{}F{}n{}W{}".format(*c))
def test_gate_cubes_matches_plain_on_flagship_shapes(cuda, case):
    _gate_case(cuda, *case, t_max=48, seed=sum(case))


@pytest.mark.parametrize("case", SMALL_GATES,
                         ids=lambda c: "G{}F{}n{}W{}".format(*c))
def test_gate_cubes_matches_plain_on_small_shapes(cuda, case):
    _gate_case(cuda, *case, t_max=300, seed=sum(case))


@pytest.mark.parametrize("case", [(256, 1, 16, 512), (128, 1, 16, 1800)],
                         ids=lambda c: "G{}F{}n{}W{}".format(*c))
def test_gate_cubes_matches_plain_on_long_flagship_covers(cuda, case):
    """Block 2's and block 1's depthwise heads with covers of up to 4,200
    cubes a filter (the flagship's reach up to ~4,100): each cover is
    split over many blocks and combined with atomics."""
    _gate_case(cuda, *case, t_max=4200, seed=sum(case))


def test_gate_cubes_wide_on_every_card(cuda):
    """n = 20 and 24 (shared memory above 48 KB: each card's kernel
    attribute set on that card) on every visible card in turn, the last
    card first, so that no card rides on another's setup."""
    for index in reversed(range(torch.cuda.device_count())):
        card = torch.device("cuda", index)
        for g, f, n, w in ((1, 2, 20, 300), (2, 1, 24, 64)):
            _gate_case(card, g, f, n, w, t_max=300, seed=n + index)


def test_gate_cubes_launches_counted_from_threads(cuda):
    """Four threads, each on a stream of its own, launch on the one card:
    every launch equals the plain version and every one is counted."""
    import threading

    gen = torch.Generator().manual_seed(11)
    planes = torch.randint(-2 ** 31, 2 ** 31, (2, 20, 300), generator=gen,
                           dtype=torch.int64).to(torch.int32).to(cuda)
    cubes, offsets = _cubes(4, 20, 200, 12)
    cubes, offsets = cubes.to(cuda), offsets.to(cuda)
    want = GC.gate_cubes_plain(planes, cubes, offsets, 2)
    before, errors = GC.gate_cubes.launches, []

    def launch():
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                for _ in range(25):
                    got = GC.gate_cubes(planes, cubes, offsets, 2)
                    stream.synchronize()
                    assert torch.equal(got, want)
        except BaseException as e:        # noqa: BLE001: asserted below
            errors.append(e)
    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert GC.gate_cubes.launches == before + 100


def _cover_of(counts, n, seed):
    """Seeded covers with the given cube counts a filter: about a quarter
    of the bits don't care, and the first cube of every cover has every
    bit fixed."""
    gen = torch.Generator().manual_seed(seed)
    counts = torch.tensor(counts, dtype=torch.int64)
    total = int(counts.sum())
    value = torch.randint(0, 2 ** n, (total,), generator=gen)
    mask = torch.zeros(total, dtype=torch.int64)
    for p in range(n):
        mask |= (torch.rand(total, generator=gen) < 0.25).long() << p
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int64)
    offsets[1:] = counts.cumsum(0)
    mask[offsets[:-1][counts > 0]] = 0
    cubes = torch.stack([value & ~mask, mask], 1).to(torch.int32)
    return cubes, offsets


@pytest.mark.parametrize("words", [100, 1800])
def test_gate_cubes_covers_on_run_boundaries(cuda, words):
    """The kernel cuts the flat cube array into S equal runs of m cubes:
    covers that end exactly on a run boundary and one cube past it, that
    start one past it, empty covers beside split ones, a cover of a single
    tautology cube and one of a single fully fixed cube, groups crossed
    inside a run (runs of 3 cubes at 100 words, of 400 at 1,800)."""
    g, f, n = 4, 4, 16
    runs = GC.segments(n, words)
    assert runs >= 4
    m = 3 if words == 100 else 400
    # filter ends: m, m (empty), 2m + 1, 3m, 3m, 3m (empty), 3m + 1 (the
    # tautology), 3m + 2 (the fixed cube), empties, then the rest
    head = [m, 0, m + 1, m - 1, 0, 0, 1, 1]
    counts = head + [0] * (g * f - len(head) - 1)
    counts.append(runs * m - sum(counts))
    assert counts[-1] >= 2
    cubes, offsets = _cover_of(counts, n, seed=words)
    cubes[3 * m, 1] = 2 ** n - 1            # filter 6: a lone tautology
    bounds = {m * s for s in range(runs + 1)}
    ends = set(offsets.tolist())
    assert {m, 3 * m} <= bounds & ends                  # ends on a boundary
    assert 2 * m + 1 in ends and 2 * m in bounds        # and one past it
    gen = torch.Generator().manual_seed(7)
    planes = torch.randint(-2 ** 31, 2 ** 31, (g, n, words), generator=gen,
                           dtype=torch.int64).to(torch.int32)
    args = [t.to(cuda) for t in (planes, cubes, offsets)]
    for invert in (False, True):
        got = GC.gate_cubes(*args, f, invert)
        torch.cuda.synchronize()
        want = GC.gate_cubes_plain(*args, f, invert)
        assert torch.equal(got, want)
        rows = got.view(g * f, words)
        ones, zero = (0, -1) if invert else (-1, 0)
        for empty in (1, 4, 5, 8, 14):
            assert (rows[empty] == zero).all()
        assert (rows[6] == ones).all()                  # the tautology
        assert not (rows[7] == ones).all()              # one minterm


def test_gate_cubes_single_cube_filters_and_refusals(cuda):
    """T = 1 everywhere (including an all-don't-care cube, constant true),
    and the wrapper's refusals, with no launch."""
    planes = torch.randint(-2 ** 31, 2 ** 31, (2, 6, 40),
                           dtype=torch.int64).to(torch.int32).to(cuda)
    cubes = torch.tensor([[5, 0], [0, 63], [9, 6], [1, 62]],
                         dtype=torch.int32, device=cuda)
    offsets = torch.arange(5, dtype=torch.int64, device=cuda)
    got = GC.gate_cubes(planes, cubes, offsets, 2)
    assert torch.equal(got, GC.gate_cubes_plain(planes, cubes, offsets, 2))
    assert (got[0, 1] == -1).all()                 # the tautology
    before = GC.gate_cubes.launches
    with pytest.raises(ValueError, match="cpu"):
        GC.gate_cubes(planes, cubes.cpu(), offsets, 2)
    with pytest.raises(ValueError, match="contiguous"):
        GC.gate_cubes(planes.transpose(1, 2).contiguous().transpose(1, 2),
                      cubes, offsets, 2)
    with pytest.raises(ValueError, match="offsets"):
        GC.gate_cubes(planes, cubes, offsets, 3)
    assert GC.gate_cubes.launches == before


def test_gate_block_on_card_equals_host(cuda):
    """A compiled block (constant filters included) run as its circuit on
    the card through the kernel equals the host evaluator, DNF and CNF,
    bf16 and f32 bits, with a ragged last word."""
    from scale_imagenet_tpu_torch.models.block_tt import BlockTT, \
        BlockTTConfig

    torch.manual_seed(0)
    cfg = BlockTTConfig(in_planes=8, out_planes=16, k=2, padding=1,
                        stride=1, groupsici=2)            # n = 16
    block = BlockTT(cfg).to(cuda).eval()
    with torch.no_grad():
        block.bn2.running_mean.uniform_(-0.3, 0.3)
        block.bn2.weight[0] = 0.0
        block.bn2.bias[0] = 5.0
    bg = gate_net.compile_block_gates(block)
    assert bg.constants[0] == 1.0 and None in bg.constants
    x = _bits((3, 8, 7, 5), False, torch.float32, 3, cuda)
    before = GC.gate_cubes.launches
    for form in ("dnf", "cnf"):
        dev = gate_device.build_device_block(bg, form, cuda)
        for dt in (torch.bfloat16, torch.float32):
            got = gate_device.gate_block_apply_device(dev, x.to(dt))
            host = gate_net.gate_block_apply(bg, x.to(dt), form)
            assert got.dtype == dt and torch.equal(got, host)
    assert GC.gate_cubes.launches == before + 4


# --------------------------------------------- the serving transforms' inputs

def _pointwise_block(groups: int, seed: int, fold: bool, dtype, device):
    """A k=1 Block_TT of 64 channels in ``groups`` groups (4: the
    flagship's first head 3; 16: the VGG stem's head 3), BN statistics
    moved off their defaults, folded into the convs when ``fold``."""
    from scale_imagenet_tpu_torch.convert.bn_fold import fold_bn_into_conv
    from scale_imagenet_tpu_torch.models.block_tt import BlockTT, \
        BlockTTConfig

    torch.manual_seed(seed)
    block = BlockTT(BlockTTConfig(in_planes=64, out_planes=64, k=1,
                                  padding=0, groupsici=groups)).eval()
    with torch.no_grad():
        for bn in (block.bn1, block.bn2):
            bn.running_mean.uniform_(-0.3, 0.3)
            bn.running_var.uniform_(0.5, 2.0)
            bn.bias.uniform_(-0.3, 0.3)
        if fold:
            fold_bn_into_conv(block.conv1, block.bn1)
            fold_bn_into_conv(block.conv2, block.bn2)
    return block.to(device=device, dtype=dtype)


@pytest.mark.parametrize("groups", [4, 16], ids=["flagship", "vgg_stem"])
@pytest.mark.parametrize("fold,dtype", [(False, torch.bfloat16),
                                        (True, torch.float32),
                                        (True, torch.bfloat16)],
                         ids=["bf16", "fold", "fold_bf16"])
def test_fused_kernel_on_folded_and_bf16_blocks(cuda, groups, fold, dtype):
    """``--bf16`` gives the kernel bf16 x (its affines folded in f32 from the
    bf16 module), ``--fold_bn`` conv biases inside the affines: the kernel
    against its plain version on the same params, through the model's
    gate."""
    block = _pointwise_block(groups, 3 * groups, fold, dtype, cuda)
    params = block.pointwise_params()
    assert all(t.dtype == torch.float32 for t in params)
    if fold:
        torch.testing.assert_close(
            params[2], block.conv1.bias.float().view(groups, -1)
            * params[1])
    x = _bits((16, 64, 11, 11), False, dtype, groups, cuda)
    before = FB.fused_pointwise_block.launches
    with fused_on():
        got = block(x)
    torch.cuda.synchronize()
    assert FB.fused_pointwise_block.launches == before + 1
    rows = x.permute(0, 2, 3, 1).reshape(-1, 64)
    want = FB.fused_pointwise_block_plain(rows, *params)
    got = got.permute(0, 2, 3, 1).reshape(-1, 64)
    assert got.dtype == dtype
    flips = got != want
    assert flips.float().mean() <= 1e-4
    pre = FB.fused_pointwise_preact_plain(rows, *params)
    assert bool((pre[flips].abs() < 1e-4).all())


# ------------------------------------------------------ the VGG-stem variant

# its two window launches at B = 256: heads 1 and 2 merged (k = 2, pad 1)
# and head 3, both n = 4 on the 11x11 stem bits
VGG_BITS = [((256, 64, 11, 11), 2, 1, 1, 64, 1, 2, False),
            ((256, 64, 11, 11), 1, 1, 0, 16, 4, 1, False)]
# its cube launches' (G, F, n, W): heads 1 and 2, head 3; n = 4 takes the
# kernel's n <= 8 instantiation
VGG_GATES = [(64, 1, 4, 1152), (16, 4, 4, 1152)]


@pytest.mark.parametrize("case", VGG_BITS,
                         ids=lambda c: f"k{c[1]}G{c[4]}F{c[5]}K{c[6]}")
def test_bit_kernel_matches_plain_on_vgg_stem_shapes(cuda, case):
    _bits_case(cuda, *case, seed=sum(case[0]) + case[4])


@pytest.mark.parametrize("case", VGG_GATES,
                         ids=lambda c: "G{}F{}n{}W{}".format(*c))
def test_gate_cubes_matches_plain_on_vgg_stem_shapes(cuda, case):
    _gate_case(cuda, *case, t_max=16, seed=sum(case))


# eval forwards: one that autograd records never takes the fused
# kernel, which has no backward (``models/block_tt.py``)
@torch.no_grad()
def test_vgg_stem_forwards_through_the_kernels(cuda, monkeypatch):
    """The VGG stem on the card: 2 window launches a LUT forward, 3 cube
    launches a gate forward, 1 fused launch a conv forward with the switch
    on; LUT logits equal the plain versions', gate logits the LUT's, and
    the argmax of all of them the conv forward's."""
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_vgg_stem_apply

    model = get_model("ttnet_imagenet_vgg_stem").init(seed=0, device=cuda)
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(3)).to(cuda)
    luts = lut_eval.compile_ttnet_lut(model)
    gnets = gate_net.compile_ttnet_gates(model)
    K.reset_launches()
    GC.reset_launches()
    FB.reset_launches()
    got = lut_eval.lut_ttnet_vgg_stem_apply(luts, model, x)
    gates = [gate_device.gate_ttnet_vgg_stem_apply_device(
        gate_device.build_device_gates(gnets, form, device=cuda), model, x)
        for form in ("dnf", "cnf")]
    ref = ttnet_vgg_stem_apply(model, x)
    with fused_on():
        fused = ttnet_vgg_stem_apply(model, x)
    torch.cuda.synchronize()
    assert (K.lut_window_bits.launches, GC.gate_cubes.launches,
            FB.fused_pointwise_block.launches) == (2, 6, 1)
    for out in (*gates, ref, fused):
        assert torch.equal(out.argmax(1), got.argmax(1))
    assert all(torch.equal(g, got) for g in gates)
    monkeypatch.setattr(lut_eval, "lut_window_bits", K.lut_window_bits_plain)
    assert torch.equal(lut_eval.lut_ttnet_vgg_stem_apply(luts, model, x), got)


# ---------------------------------------------- the v2 and TT_FHE families

# the TT_FHE window launches at p = 64 and B = 256: TT_FHE_SMALL's heads
# 1 and 2 merged (k = 2, pad 1, n = 4), head 3 and fuse head (n = 4);
# TT_FHE_XSMALL_vAlexnet's (3,2) and (2,3) heads (n = 6) and head 3 (n = 8)
FHE_BITS = [((256, 64, 16, 16), 2, 1, 1, 64, 1, 2, False),
            ((256, 64, 16, 16), 1, 1, 0, 16, 4, 1, False),
            ((256, 256, 17, 17), 1, 1, 0, 64, 4, 1, False),
            ((256, 64, 10, 10), (3, 2), 1, 1, 64, 1, 1, False),
            ((256, 64, 10, 10), (2, 3), 1, 1, 64, 1, 1, False),
            ((256, 64, 10, 10), 1, 1, 0, 8, 8, 1, False)]
# and their cube launches' (G, F, n, W)
FHE_GATES = [(64, 1, 4, 2312), (16, 4, 4, 2048), (64, 4, 4, 2312),
             (64, 1, 6, 880), (8, 8, 8, 800)]


@pytest.mark.parametrize("case", FHE_BITS,
                         ids=lambda c: f"{c[0][2]}k{c[1]}G{c[4]}F{c[5]}K"
                                       f"{c[6]}")
def test_bit_kernel_matches_plain_on_fhe_shapes(cuda, case):
    _bits_case(cuda, *case, seed=sum(case[0]) + case[4])


@pytest.mark.parametrize("case", FHE_GATES,
                         ids=lambda c: "G{}F{}n{}W{}".format(*c))
def test_gate_cubes_matches_plain_on_fhe_shapes(cuda, case):
    _gate_case(cuda, *case, t_max=2 ** (case[2] - 1), seed=sum(case))


@pytest.mark.parametrize("name", ["TT_FHE_SMALL", "TT_FHE_XSMALL_vAlexnet"])
# eval forwards: one that autograd records never takes the fused
# kernel, which has no backward (``models/block_tt.py``)
@torch.no_grad()
def test_fhe_forwards_through_the_kernels(cuda, name, monkeypatch):
    """A TT_FHE model at p = 64 on the card: its LUT forward through the
    window kernel equals the plain versions', its DNF and CNF circuits
    equal the LUT forward, and its conv forward with the switch on launches
    the fused kernel once a k=1 block and keeps the unfused argmax."""
    from scale_imagenet_tpu_torch import main as cli

    model = get_model(name).init(seed=0, device=cuda)
    fam = cli._family(model.cfg)
    x = torch.rand((8, 32, 32, 3), generator=torch.Generator()
                   .manual_seed(4)).to(cuda)
    luts = fam.lut_compile(model)
    gnets = fam.gate_compile(model)
    K.reset_launches()
    GC.reset_launches()
    FB.reset_launches()
    got = fam.lut(luts, model, x)
    gates = [fam.gate_device(gate_device.build_device_gates(
        gnets, form, device=cuda), model, x) for form in ("dnf", "cnf")]
    ref = fam.conv(model, x)
    with fused_on():
        fused = fam.conv(model, x)
    torch.cuda.synchronize()
    # TT_FHE_SMALL: heads 1+2 merged, head 3, fuse head; vAlexnet: heads
    # 1 and 2 apart ((3,2) and (2,3)), head 3, no fuse head
    k1 = 2 if name == "TT_FHE_SMALL" else 1      # head 3 (and the fuse head)
    assert (K.lut_window_bits.launches, GC.gate_cubes.launches,
            FB.fused_pointwise_block.launches) == (3, 2 * (2 + k1), k1)
    assert all(torch.equal(g, got) for g in gates)
    assert torch.equal(fused.argmax(1), ref.argmax(1))
    assert torch.equal(ref.argmax(1), got.argmax(1))
    monkeypatch.setattr(lut_eval, "lut_window_bits", K.lut_window_bits_plain)
    assert torch.equal(fam.lut(luts, model, x), got)


# eval forwards: one that autograd records never takes the fused
# kernel, which has no backward (``models/block_tt.py``)
@torch.no_grad()
def test_v2_conv_forward_through_the_fused_kernel(cuda):
    """The v2 variant at p = 64 with the switch on: each of its 6 k=1
    blocks (ci = 32) launches the fused kernel, and the argmax is the
    unfused forward's."""
    model = get_model("ttnet_imagenet_v2").init(seed=0, device=cuda)
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(5)).to(cuda)
    ref = ttnet_imagenet_apply(model, x)
    FB.reset_launches()
    with fused_on():
        got = ttnet_imagenet_apply(model, x)
    torch.cuda.synchronize()
    assert FB.fused_pointwise_block.launches == 6
    assert torch.equal(got.argmax(1), ref.argmax(1))


def test_noisy_heaviside_on_the_card(cuda):
    """The dead-zone Heaviside on CUDA tensors: a ``NoiseKey`` draws its
    flips on the card's generator (the same key the same flips, {0, 1}
    about half each); given the CPU's flips the card's outputs and STE
    gradients equal the CPU's; ``TT_FHE_small`` repeats from its key on
    the card and never takes the fused kernel."""
    from scale_imagenet_tpu_torch.ops import NoiseKey, heaviside01_noisy

    gen = torch.Generator().manual_seed(4)
    x = torch.rand((64, 32, 16, 16), generator=gen) * 0.4 - 0.2
    key = NoiseKey(11).child(3)
    a = key.draw(x.to(cuda))
    assert a.is_cuda and torch.equal(a, key.draw(x.to(cuda)))
    assert set(a.unique().tolist()) == {0.0, 1.0}
    assert abs(float(a.mean()) - 0.5) < 0.01
    flips = key.draw(x)
    outs, grads = [], []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).clone().requires_grad_()
        out = heaviside01_noisy(xd, 0.1, flips.to(dev))
        out.backward(torch.ones_like(out))
        outs.append(out.detach().cpu())
        grads.append(xd.grad.cpu())
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-7)
    model = get_model("TT_FHE_small").init(seed=0, device=cuda)
    xs = torch.rand((8, 32, 32, 3), generator=gen).to(cuda)
    FB.reset_launches()
    with torch.no_grad(), fused_on():
        first = model(xs, noise=NoiseKey(5))
        again = model(xs, noise=NoiseKey(5))
        other = model(xs, noise=NoiseKey(6))
    assert FB.fused_pointwise_block.launches == 0
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert bool(torch.isfinite(first).all())


def test_v1_forward_on_the_card_matches_the_cpu(cuda):
    """``TT_vf_19lv2_imgnet`` at full width (p = 64, 224x224): the card's
    f32 logits against the CPU's from the same weights (TF32 off): the
    same top-1, and within 1e-2 of the largest logit (cuDNN sums in
    another order, and a 2-bit quantizer may round a value on a step the
    other way)."""
    from scale_imagenet_tpu_torch.models.ttnet_imagenet_v1 import \
        ttnet_v1_apply

    model = get_model("TT_vf_19lv2_imgnet").init(seed=0, device="cpu")
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(5))
    with torch.no_grad():
        want = ttnet_v1_apply(model, x)
        got = ttnet_v1_apply(model.to(cuda), x.to(cuda)).cpu()
    assert got.shape == (4, 1000) and bool(torch.isfinite(got).all())
    assert torch.equal(got.argmax(1), want.argmax(1))
    err = float((got - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max()), err


def test_attack_takes_the_fused_kernel_only_when_undifferentiated(cuda):
    """``make_eval_step`` with ``--attack pgd``'s step on the flagship, the
    switch on: the clean and the adversarial forwards launch the kernel
    (6 each), the two PGD steps' differentiated forwards none; the
    parameters are frozen during the attack and thawed after it."""
    from scale_imagenet_tpu_torch.train import make_eval_step

    md = get_model("ttnet_imagenet_small")
    model = md.init(seed=0, device=cuda)
    x = torch.rand((4, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(3)).to(cuda)
    step = make_eval_step(lambda a, **k: model(a, **k), md=md, model=model,
                          attack={"kind": "pgd", "eps": 2 / 255,
                                  "steps": 2})
    FB.reset_launches()
    with fused_on():
        out = step(x, torch.tensor([0, 1, 2, -1], device=cuda))
    torch.cuda.synchronize()
    assert FB.fused_pointwise_block.launches == 12
    assert set(out) == {"loss", "top1", "top5", "n", "adv"}
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("name", ["cifar10lownoise", "tt_certif"])
def test_interval_bounds_on_the_card_match_the_cpu(cuda, name):
    """``interval_logits`` at the registry width on the card against the
    CPU's from the same weights and images (TF32 off): within 1e-4
    relative, and the card's concrete logits at points in the ball (fresh
    coin flips for ``tt_certif``) inside its bounds."""
    from scale_imagenet_tpu_torch.ops import NoiseKey
    from scale_imagenet_tpu_torch.train.steps import _pixel_ball

    md = get_model(name)
    model = md.init(seed=0, device="cpu")
    x = torch.rand((8, 32, 32, 3), generator=torch.Generator()
                   .manual_seed(4)) * 2 - 1
    eps, lo, hi = _pixel_ball(4 / 255, ((0.5,) * 3, (0.25,) * 3))
    with torch.no_grad():
        want = md.interval_logits(model, x, eps, lo, hi)
        model.to(cuda)
        ball = [b.to(cuda) for b in (eps, lo, hi)]
        got = md.interval_logits(model, x.to(cuda), *ball)
        for i in range(4):
            u = torch.rand(x.shape, generator=torch.Generator()
                           .manual_seed(10 + i)).to(cuda) * 2 - 1
            pt = torch.minimum(torch.maximum(x.to(cuda) + u * ball[0],
                                             ball[1]), ball[2])
            y = model(pt, **({"noise": NoiseKey(i)} if md.stochastic
                             else {}))
            tol = 1e-5 * got.vmax.abs().clamp(min=1.0)
            assert bool((y >= got.vmin - tol).all())
            assert bool((y <= got.vmax + tol).all())
    for g, w in ((got.vmin, want.vmin), (got.vmax, want.vmax)):
        err = ((g.cpu() - w).abs() / w.abs().clamp(min=1.0)).max()
        assert float(err) <= 1e-4, float(err)
