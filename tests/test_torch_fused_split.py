"""The fused pointwise kernel's precision design, emulated on the CPU.

The tensor-core body of ``csrc/fused_block.cu`` runs both group products
of the fused pointwise block as three TF32 products: each f32 operand ``a``
is split into ``a_hi = rna(a)`` and ``a_lo = rna(a - a_hi)``, where ``rna``
is ``cvt.rna.tf32.f32`` (the mantissa rounded to 10 bits, to nearest, ties
away from zero), and ``a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi``.  This
file rounds as that instruction does, in torch, on seeded numpy inputs at
the flagship's and v2's ``(ci, m, co)``, on {0,1} bits and on continuous
x, and shows

(a) that the three-product split meets the card's contract against
    ``fused_pointwise_block_plain``: Heaviside outputs flip in at most 1e-4
    of the outputs, each flip within 1e-4 of the threshold in the plain
    pre-activation; ReLU outputs within 1e-5;
(b) that a single TF32 product of each GEMM does not.

It also holds ``fused_body``, the query of which body the launcher takes.
"""

import numpy as np
import pytest
import torch

from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.ops.gelu import fast_gelu

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

# (G, ci, m, co, E): a flagship head 3 and a v2 head 3, E cut to thousands
SHAPES = {"flagship": (4, 16, 128, 16, 4000), "v2": (2, 32, 256, 32, 3000)}
FLIP_SHARE = 1e-4        # chip_smoke.py::fused_case, tests/test_torch_cuda
FLIP_NEAR = 1e-4
RELU_TOL = 1e-5


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite f32 values: add half a unit of the
    10-bit mantissa's last place to the magnitude, then drop the 13 low
    bits (a tie goes away from zero)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32)


def _split(t: torch.Tensor):
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def _product(a: torch.Tensor, b: torch.Tensor, products: int):
    """``a @ b`` (batched over groups) as the tensor cores take it: three
    TF32 products, the small ones first, or one."""
    if products == 1:
        return torch.bmm(tf32_rna(a), tf32_rna(b))
    ah, al = _split(a)
    bh, bl = _split(b)
    return (torch.bmm(al, bh) + torch.bmm(ah, bl)) + torch.bmm(ah, bh)


def emulated_preact(x, w1, s1, b1, w2, s2, b2, products: int):
    """The kernel's pre-activation ``(N, G*co)`` with both group products
    emulated in TF32; BN1, GELU and BN2 in f32, as the kernel does them."""
    g, ci, _ = w1.shape
    n = x.shape[0]
    xg = x.reshape(n, g, ci).transpose(0, 1)
    h = _product(xg, w1, products) * s1.unsqueeze(1) + b1.unsqueeze(1)
    y = _product(fast_gelu(h), w2, products) * s2.unsqueeze(1) + \
        b2.unsqueeze(1)
    return y.transpose(0, 1).reshape(n, -1)


def _inputs(shape: str, continuous: bool):
    """Seeded numpy inputs of one launch, scaled as the card tests' are."""
    g, ci, m, co, n = SHAPES[shape]
    rng = np.random.default_rng(g * ci + co + int(continuous))
    x = rng.standard_normal((n, g * ci)) if continuous else \
        (rng.random((n, g * ci)) < 0.5)
    arrays = [x, rng.standard_normal((g, ci, m)) / ci ** 0.5,
              1 + 0.1 * rng.standard_normal((g, m)),
              0.3 * rng.standard_normal((g, m)),
              rng.standard_normal((g, m, co)) / m ** 0.5,
              1 + 0.1 * rng.standard_normal((g, co)),
              0.3 * rng.standard_normal((g, co))]
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _contract(x, params, act: str, products: int) -> tuple:
    """``(holds, measure)``: whether the emulated kernel meets the card's
    contract against the plain version, and the number it was judged by
    (the largest ReLU difference, or the largest distance of a flipped
    Heaviside output from its threshold and the flip share)."""
    pre = emulated_preact(x, *params, products)
    want = FB.fused_pointwise_block_plain(x, *params, act=act)
    if act == "relu":
        err = float((torch.relu(pre) - want).abs().max())
        return err <= RELU_TOL, err
    flips = (pre >= 0).float() != want
    share = float(flips.float().mean())
    near = FB.fused_pointwise_preact_plain(x, *params)[flips]
    far = float(near.abs().max()) if near.numel() else 0.0
    return share <= FLIP_SHARE and far < FLIP_NEAR, (far, share)


@pytest.mark.parametrize("act", ["heaviside", "relu"])
@pytest.mark.parametrize("continuous", [False, True],
                         ids=["bits", "continuous"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_three_tf32_products_meet_the_contract(shape, continuous, act):
    x, *params = _inputs(shape, continuous)
    holds, measure = _contract(x, params, act, products=3)
    assert holds, measure


@pytest.mark.parametrize("act", ["heaviside", "relu"])
@pytest.mark.parametrize("continuous", [False, True],
                         ids=["bits", "continuous"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_one_tf32_product_breaks_the_contract(shape, continuous, act):
    x, *params = _inputs(shape, continuous)
    holds, measure = _contract(x, params, act, products=1)
    assert not holds, measure


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's last place at 1
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp,
                         float(tf32_rna(torch.tensor([3.0e-39]))), 0.0])
    assert torch.equal(tf32_rna(v), want)
    # hi + lo keeps ~22 significant bits of any f32
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32))
    hi, lo = _split(a)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert float(((hi + lo - a).abs() / a.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("ci,m,co,body", [
    (16, 128, 16, "tensor_core"), (16, 128, 8, "tensor_core"),
    (32, 256, 32, "tensor_core"), (32, 256, 16, "tensor_core"),
    (8, 64, 8, "tensor_core"), (16, 40, 16, "fma"), (8, 24, 8, "fma"),
    (4, 32, 4, "fma"), (2, 16, 1, "fma"), (8, 64, 16, "fma")])
def test_fused_body_by_shape(ci, m, co, body):
    assert FB.fused_body(ci, m, co) == body


@pytest.mark.parametrize("ci,m,co", [(3, 24, 3), (32, 256, 8), (64, 512, 64),
                                     (16, 0, 16)])
def test_fused_body_refuses_what_the_kernel_does_not_cover(ci, m, co):
    with pytest.raises(ValueError, match="does not cover"):
        FB.fused_body(ci, m, co)
