"""Spatial partitioning (``scale_imagenet_tpu_torch/parallel/sp.py``,
``--sp``) in one process: M model ranks emulated by M threads, joined by
an in-process stand-in for a process group whose ``all_reduce`` sums the
ranks' tensors in rank order (``Loopback``), all in f64:

* the partition: GSPMD's ceiling split covers every height once, uneven
  and with empty slices where the height is short;
* each row-sharded op (the s2d and reference stems, a padded strided
  head, the stride-2 pool, the fix-up pads and the crop, the gather, and
  the generic convs, pools (the padded max pool's -inf pad), pads, crops
  and crop to the smallest of the other families) and its input
  gradient against the unsharded op, at heights {56, 29, 15, 8, 7} and
  the short 5 and 3 (a rank owning fewer rows than a halo, and an empty
  one), M in {2, 4};
* the sharded forward of ``ttnet_imagenet_xsmall`` (nfilter = tfilter =
  4, layers 0, 224², the size of JAX's ``test_sp_eval_step_exact``) and
  of the small variant at layers 1 and its narrowest width (p = 1):
  logits equal to the port's unsharded forward to 1e-9, the sharded eval
  step's metrics equal to JAX's unsharded ``make_eval_step(model)``, its
  ``--attack fgsm`` metric equal to the unsharded step's;
* the input gradient under sharding (what ``--attack`` differentiates)
  against the unsharded one, to 1e-9;
* the fused switch: the sharded forward through the plain version equals
  the unsharded one, the k = 1 heads taking it on each rank's rows;
* ``make_eval_step(spatial=True)`` without a mesh raises JAX's text.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import few_threads, images, port_and_trees, \
    run_ranks  # noqa: F401

from scale_imagenet_tpu.train.steps import make_eval_step as jmake_eval_step
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch.layers.pool import avg_pool
from scale_imagenet_tpu_torch.models import block_tt as block_tt_module
from scale_imagenet_tpu_torch.models.block_tt import BlockTT, \
    BlockTTConfig, block_tt
from scale_imagenet_tpu_torch.models.ttnet_imagenet import TTnetImageNet, \
    TTnetImageNetConfig, init_ttnet_imagenet, stem
from scale_imagenet_tpu_torch.parallel import sp, sp_models
from scale_imagenet_tpu_torch.parallel.mesh import Mesh
from scale_imagenet_tpu_torch.robust.attack import _loss_grad
from scale_imagenet_tpu_torch.train import make_eval_step

pytestmark = pytest.mark.usefixtures("few_threads", "x64_module")

HEIGHTS = (56, 29, 15, 8, 7, 5, 3)
XS = dict(nfilter=4, tfilter=4, layers=0)
# the small variant's narrowest width: p = 1 (its group counts clamp to 1)
SMALL = dict(nfilter=1, tfilter=1, layers=1)


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def held(x: torch.Tensor, h: int, n: int, m: int) -> torch.Tensor:
    """Rank ``m``'s rows of NCHW ``x`` (height ``h``): its own, or one
    phantom row of zeros where it owns none."""
    lo, hi = sp.row_bounds(h, n, m)
    return x[:, :, lo:hi] if hi > lo else torch.zeros_like(x[:, :, :1])


def own(y: torch.Tensor, h: int, n: int, m: int) -> torch.Tensor:
    lo, hi = sp.row_bounds(h, n, m)
    return y[:, :, :hi - lo]


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("h", HEIGHTS)
def test_partition_covers_each_row_once(h, n):
    c = -(-h // n)
    bounds = [sp.row_bounds(h, n, m) for m in range(n)]
    rows = [r for lo, hi in bounds for r in range(lo, hi)]
    assert rows == list(range(h))
    assert all(hi - lo == min(c, max(h - lo, 0)) for lo, hi in bounds)
    if (h, n) == (29, 4):
        assert [hi - lo for lo, hi in bounds] == [8, 8, 8, 5]
    if (h, n) == (3, 4):
        assert bounds[3] == (3, 3)


def _block(k, pad, stride, seed):
    torch.manual_seed(seed)
    cfg = BlockTTConfig(in_planes=4, out_planes=4, k=k, t=2, padding=pad,
                        stride=stride, groupsici=2)
    return BlockTT(cfg).double().eval()


def _stem_model(impl: str):
    model = TTnetImageNet(TTnetImageNetConfig(
        variant="xsmall", nfilter=2, tfilter=2, layers=0, stem_impl=impl))
    init_ttnet_imagenet(model, torch.Generator().manual_seed(3))
    return model.double().eval()


def _ops():
    """``name -> (unsharded op on NCHW, sharded op (x, h, shard) -> (rows,
    height), channels in)``."""
    head = _block(4, 2, 2, 0)
    head_xs = _block(2, 1, 2, 1)
    stems = {impl: _stem_model(impl) for impl in ("s2d", "reference")}
    gen = torch.Generator().manual_seed(4)
    w7, b7 = (torch.randn((3, 4, 7, 7), generator=gen, dtype=torch.float64),
              torch.randn(3, generator=gen, dtype=torch.float64))
    w3 = torch.randn((4, 2, 3, 3), generator=gen, dtype=torch.float64)
    w1 = torch.randn((3, 4, 1, 1), generator=gen, dtype=torch.float64)
    return {
        "head_k4_s2_p2": (lambda x: block_tt(head, x),
                          lambda x, h, s: sp.sp_block_tt(head, x, h, s), 4),
        "head_k2_s2_p1": (lambda x: block_tt(head_xs, x),
                          lambda x, h, s: sp.sp_block_tt(head_xs, x, h, s),
                          4),
        "avg_pool": (lambda x: avg_pool(x, 2), sp.sp_avg_pool, 4),
        "pad_top": (lambda x: F.pad(x, (0, 0, 1, 0)),
                    lambda x, h, s: (sp.sp_shift_rows(x, h, h + 1, 1, s),
                                     h + 1), 4),
        "pad_bottom_2": (lambda x: F.pad(x, (0, 0, 0, 2)),
                         lambda x, h, s: (sp.sp_shift_rows(x, h, h + 2, 0,
                                                           s), h + 2), 4),
        "crop": (lambda x: x[:, :, :x.shape[2] - 1],
                 lambda x, h, s: (sp.sp_shift_rows(x, h, h - 1, 0, s),
                                  h - 1), 4),
        **{f"stem_{impl}": (
            lambda x, m=m: stem(m, x),
            lambda x, h, s, m=m: sp_models.sp_stem(m, x, h, s), 3)
           for impl, m in stems.items()},
        # the other families' row-mixing ops (``sp.py``'s generic ones)
        "conv_k7_s2_p3": (lambda x: F.conv2d(x, w7, b7, 2, 3),
                          lambda x, h, s: sp.sp_conv2d(x, h, s, w7, b7, 2,
                                                       3), 4),
        "conv_k3_p1_grouped": (
            lambda x: F.conv2d(x, w3, None, 1, 1, groups=2),
            lambda x, h, s: sp.sp_conv2d(x, h, s, w3, None, 1, 1, 2), 4),
        "conv_k1_s2": (lambda x: F.conv2d(x, w1, None, 2),
                       lambda x, h, s: sp.sp_conv2d(x, h, s, w1, None, 2),
                       4),
        # the padded max pool pads with -inf: a zero pad would win where a
        # window's rows are all negative
        "max_pool_k3_s2_p1": (lambda x: F.max_pool2d(x, 3, 2, 1),
                              lambda x, h, s: sp.sp_max_pool(x, h, s, 3, 2,
                                                             1), 4),
        "max_pool_k3": (lambda x: F.max_pool2d(x, 3),
                        lambda x, h, s: sp.sp_max_pool(x, h, s, 3), 4),
        "avg_pool_k3_s2_p1": (lambda x: F.avg_pool2d(x, 3, 2, 1),
                              lambda x, h, s: sp.sp_avg_pool(x, h, s, 3, 2,
                                                             1), 4),
        "crop_last": (lambda x: x[:, :, :-1, :-1],
                      lambda x, h, s: sp.sp_zero_pad2d(x, h, s,
                                                       (0, -1, 0, -1)), 4),
        "pad_top_left": (lambda x: F.pad(x, (1, 0, 1, 0)),
                         lambda x, h, s: sp.sp_zero_pad2d(x, h, s,
                                                          (1, 0, 1, 0)), 4),
        # the crop of two outputs to the smaller
        "crop_cat": (lambda x: torch.cat([x[:, :2, :-1, :-1],
                                          x[:, 2:, :-1, :-1]], 1),
                     lambda x, h, s: sp.sp_crop_cat(
                         [x[:, :2], sp.sp_zero_pad2d(x[:, 2:], h, s,
                                                     (0, -1, 0, -1))[0]],
                         [h, h - 1], s), 4),
    }


OPS = _ops()


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("op", sorted(OPS))
def test_sharded_op_equals_unsharded(op, h, n):
    """Forward rows and the input gradient of a seeded cotangent, through
    the exchange's transpose, equal the unsharded op's in f64."""
    plain, sharded, c = OPS[op]
    rng = np.random.default_rng(h * 10 + n)
    x = torch.from_numpy(rng.standard_normal((2, c, h, 9)))
    if op.startswith("stem"):
        x = x.abs()
    xg = x.clone().requires_grad_(True)
    want = plain(xg)
    cot = torch.from_numpy(rng.standard_normal(want.shape))
    (gwant,) = torch.autograd.grad((want * cot).sum(), xg)

    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        xl = held(x, h, n, m).clone().requires_grad_(True)
        y, h_out = sharded(xl, h, shard)
        lo, hi = sp.row_bounds(h_out, n, m)
        assert y.shape[2] == max(1, hi - lo)
        mine = own(y, h_out, n, m)
        (g,) = torch.autograd.grad((mine * cot[:, :, lo:hi]).sum(), xl)
        return mine.detach(), own(g, h, n, m), h_out

    outs = run_ranks(n, rank)
    assert outs[0][2] == want.shape[2]
    got = torch.cat([o[0] for o in outs], dim=2)
    assert got.shape == want.shape
    assert torch.allclose(got, want.detach(), rtol=0, atol=1e-12)
    g = torch.cat([o[1] for o in outs], dim=2)
    assert torch.allclose(g, gwant, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("h", (8, 7, 3))
def test_gather_rows_and_its_backward(h, n):
    """Every rank gets the whole tensor; the backward keeps each rank's
    own rows of the gradient of the loss that every rank holds (a sum over
    the ranks would count it n times)."""
    rng = np.random.default_rng(h + n)
    x = torch.from_numpy(rng.standard_normal((2, 3, h, 4)))
    cot = torch.from_numpy(rng.standard_normal(x.shape))

    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        xl = held(x, h, n, m).clone().requires_grad_(True)
        full = sp.gather_rows(xl, h, shard)
        (g,) = torch.autograd.grad((full * cot).sum(), xl)
        return full.detach(), own(g, h, n, m)

    outs = run_ranks(n, rank)
    assert all(torch.equal(full, x) for full, _ in outs)
    assert torch.equal(torch.cat([g for _, g in outs], dim=2), cot)


@pytest.mark.parametrize("channels_last", (True, False))
def test_slabs_keep_the_memory_format(channels_last):
    """A rank's rows are stored as a whole batch is, and a slab keeps the
    NCHW tensor's memory format (``channels_last`` for the images' NHWC
    view and what the ops make from it), so that an op on it takes the
    algorithm, and the rounding, it takes on the whole tensor."""
    images = torch.zeros((2, 8, 5, 3))
    rows = sp.local_rows(images, sp.RowShard(2, 1))
    assert rows.is_contiguous()
    x = rows.permute(0, 3, 1, 2)
    if not channels_last:
        x = x.contiguous()
    fmt = torch.channels_last if channels_last else torch.contiguous_format

    def rank(m, group):
        slab, _ = sp.sp_window(x, 8, sp.RowShard(2, m, group), 3, 1, 1)
        return slab.is_contiguous(memory_format=fmt)

    assert all(run_ranks(2, rank))


def test_sharded_heads_meet_fewer_rows_than_a_halo_and_an_empty_rank():
    """Height 7 over four ranks owns 2, 2, 2, 1 rows, and rank 1's output
    of the k = 4 head reads two rows of rank 0 and rank 3's two of rank
    2; height 3 leaves rank 3 empty: it still takes part in every
    exchange, forward and backward."""
    assert [sp.row_bounds(7, 4, m) for m in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 7)]
    needs = tuple((o * 2 - 2, o * 2 + 2) for o in range(4))
    runs, total = sp._halos(7, 4, needs)
    assert runs == ((), ((0, 2, 0),), ((2, 4, 2),), ((4, 6, 4),))
    assert total == 6
    assert sp.row_bounds(3, 4, 3) == (3, 3)


@pytest.fixture(scope="module")
def xsmall():
    """``(jax_model, params, state, port_model)`` holding one set of f64
    weights, BN statistics perturbed."""
    jm, params, state, _, model = port_and_trees("ttnet_imagenet_xsmall",
                                                 seed=0, **XS)
    return jm, params, state, model


@pytest.fixture(scope="module")
def small():
    jm, params, state, _, model = port_and_trees("ttnet_imagenet_small",
                                                 seed=2, **SMALL)
    return jm, params, state, model


def _batch(seed: int, b: int = 4):
    x = images((b, 224, 224, 3), seed)
    labels = np.random.default_rng(seed).integers(0, 1000, b)
    return torch.from_numpy(x), torch.from_numpy(labels)


def _sharded_logits(model, x, n):
    """Each rank's logits, in eval (grad mode is a thread's own)."""
    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        with torch.no_grad():
            return sp_models.sp_ttnet_imagenet_apply(
                model, sp.local_rows(x, shard), shard)
    return run_ranks(n, rank)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("which", ("xsmall", "small"))
def test_sharded_forward_equals_unsharded(which, n, xsmall, small):
    model = (xsmall if which == "xsmall" else small)[3]
    x, _ = _batch(5)
    with torch.no_grad():
        want = model(x)
    for got in _sharded_logits(model, x, n):
        assert torch.allclose(got, want, rtol=0, atol=1e-9)


def _mesh(n: int, m: int, group) -> Mesh:
    mesh = Mesh(1, n, m)
    mesh.model_group = group
    return mesh


@pytest.mark.parametrize("which", ("xsmall", "small"))
def test_sharded_eval_step_metrics_equal_jax(which, xsmall, small):
    """The port's ``make_eval_step(spatial=True)`` on a 1 x 4 mesh (each
    rank keeping its rows of the whole batch) equals JAX's unsharded
    ``make_eval_step(model)`` on the same weights and images; the
    ``--attack fgsm`` metric equals the port's unsharded step's."""
    jm, params, state, model = xsmall if which == "xsmall" else small
    x, labels = _batch(9)
    labels[3] = -1                     # a pad row of the last batch
    ref = jmake_eval_step(jm)(params, state, jnp.asarray(x.numpy()),
                              jnp.asarray(labels.numpy()))
    attack = {"kind": "fgsm", "eps": 2 / 255, "steps": 1, "step_size": None}
    plain = make_eval_step(model, model=model, attack=attack)(x, labels)

    def rank(m, group):
        mesh = _mesh(4, m, group)
        step = make_eval_step(sp_models.sp_forward(model, sp.row_shard(mesh)),
                              model=model, attack=attack, mesh=mesh,
                              spatial=True)
        return {k: float(v) for k, v in step(x, labels).items()}

    for got in run_ranks(4, rank):
        for k in ("loss", "top1", "top5", "n"):
            assert got[k] == pytest.approx(float(ref[k]), rel=1e-9,
                                           abs=1e-9), k
        assert got["adv"] == pytest.approx(float(plain["adv"]), abs=1e-9)


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_input_gradient_equals_unsharded(n, xsmall):
    """The cross-entropy's gradient with respect to the images, each rank
    holding its rows: the concatenated rows equal the unsharded gradient
    to 1e-9 of its largest entry."""
    model = xsmall[3]
    x, labels = _batch(11)
    want = _loss_grad(model, x, labels)

    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        return _loss_grad(sp_models.sp_forward(model, shard),
                          sp.local_rows(x, shard), labels)

    got = torch.cat(run_ranks(n, rank), dim=1)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-9 * scale


def test_fused_switch_runs_on_each_ranks_rows(xsmall):
    """With ``fused_pointwise_blocks`` on, the k = 1 heads of the sharded
    forward go through the fused wrapper on each rank's rows (its plain
    version on the CPU), and the logits equal the unsharded forward's
    with the switch on."""
    model = xsmall[3]
    x, _ = _batch(13)
    calls = []
    real = block_tt_module.fused_pointwise_nchw

    def counted(t, *a, **k):
        calls.append(t.shape[2])
        return real(t, *a, **k)

    saved = config.performance.fused_pointwise_blocks
    config.performance.fused_pointwise_blocks = True
    try:
        with mock.patch.object(block_tt_module, "fused_pointwise_nchw",
                               counted), torch.no_grad():
            want = model(x)
            assert len(calls) == 4      # head 3 and the fuse head a block
            calls.clear()
            got = _sharded_logits(model, x, 2)
    finally:
        config.performance.fused_pointwise_blocks = saved
    assert len(calls) == 2 * 4
    # each rank's own rows: 56 -> 28 at the first block's head 3, 29 ->
    # 15 and 14 at its fuse head
    assert sorted(calls)[-2:] == [28, 28]
    for g in got:
        assert torch.allclose(g, want, rtol=0, atol=1e-9)


def test_sp_requires_mesh(xsmall):
    with pytest.raises(ValueError, match="needs a mesh") as got:
        make_eval_step(xsmall[3], spatial=True)
    with pytest.raises(ValueError) as want:
        jmake_eval_step(xsmall[0], None, spatial=True)
    assert str(got.value) == str(want.value)

