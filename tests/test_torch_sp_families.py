"""``--sp`` for every family (``scale_imagenet_tpu_torch/parallel/
sp_models.py``) in one process: M model ranks emulated by M threads joined
by ``_torch_port.Loopback``, all in f64, against the port's unsharded
forwards (which the other ``test_torch_*`` files hold against JAX):

* every config type of ``main.py``'s ``_FAMILIES``, by one registry name
  or more at narrow widths and few layers, at M = 2 and 4: the sharded
  logits within 1e-12 of the unsharded forward's on every rank, and every
  Heaviside output (each rank's rows) equal bit for bit, the coin flips
  of ``TT_FHE_small`` and ``tt_certif`` from one ``NoiseKey`` included;
  the 32² families leave 8, 4, 2 and then 1 row a rank, and empty slices;
* ``resnet18`` at 224²; the CIFAR one under ``--fuse_quant`` and
  ``--fold_bn``;
* the fused switch on the VGG stem and ``TT_FHE_SMALL``: the k = 1 heads
  take the fused wrapper (its plain version here) on each rank's rows;
* the input gradient (``--attack``'s) of a 224² and a 32² family, to 1e-9
  of its largest entry;
* ``RowNoise``: a site's flips are the global draw's rows;
* ``--certify``: the three interval families' row-sharded logit bounds
  within 1e-12 of ``interval_logits``, the certified masks equal, and the
  sharded eval step's ``cert``, ``adv`` and metrics equal to the
  unsharded step's.
"""

import copy
import dataclasses
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port import few_threads, run_ranks  # noqa: F401

from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch.convert.bn_fold import fold_model_bns
from scale_imagenet_tpu_torch.convert.fuse_quant import fuse_resnet
from scale_imagenet_tpu_torch.main import _FAMILIES
from scale_imagenet_tpu_torch.models import block_tt as block_tt_module
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    TTnetImageNetConfig
from scale_imagenet_tpu_torch.ops import binarize
from scale_imagenet_tpu_torch.ops.binarize import NoiseKey
from scale_imagenet_tpu_torch.parallel import sp
from scale_imagenet_tpu_torch.parallel.mesh import Mesh
from scale_imagenet_tpu_torch.parallel.sp_models import SP_FAMILIES, \
    sp_forward, sp_interval_logits
from scale_imagenet_tpu_torch.robust.attack import _loss_grad
from scale_imagenet_tpu_torch.robust.interval import certified_mask
from scale_imagenet_tpu_torch.train import make_eval_step

pytestmark = pytest.mark.usefixtures("few_threads")

# registry name -> (model kwargs, config fields replaced, image side)
CASES = {
    "TT_vf_19lv3_imgnet_xsmall_VGG": ({}, dict(num_classes=10,
                                               classifier_inter=16), 224),
    "TT_FHE_small": (dict(nfilter=1, tfilter=8), {}, 32),
    "TT_FHE_SMALL": (dict(nfilter=1, tfilter=8), {}, 32),
    "TT_FHE_XSMALL_vAlexnet": ({}, dict(p=8), 32),
    "TT_vf_19lv2_imgnet": (dict(nfilter=1, tfilter=4), {}, 224),
    "TT_vf_17l_cifar": (dict(nfilter=1, tfilter=4), {}, 32),
    # ``tests/test_torch_general.py``'s widths and sizes; a_bit = 1 gives
    # TT_general Heaviside outputs
    "TT_general": (dict(nfilter=2, tfilter=2, a_bit=1), {}, 224),
    "TT_general_8": (dict(nfilter=2, tfilter=2, image_size=64), {}, 64),
    "TT_general_big": (dict(nfilter=2, tfilter=2, image_size=64), {}, 64),
    "TT_general_correctBN": (dict(nfilter=2, tfilter=6), {}, 224),
    "TT_general_correctBN_cifar": (dict(nfilter=2, tfilter=6), {}, 32),
    "mobilenet_v2_tt": ({}, {}, 32),
    "mobilenet_v1_tt": ({}, dict(n=1, t=2), 32),
    "model_general": ({}, dict(preprocessing_cnn=(8, 3, 2), filters=(8,),
                               amplifications=(4,), groups=(8,)), 32),
    "cifar10lownoise": ({}, {}, 32),
    "tt_certif": (dict(nfilter=1, tfilter=3), {}, 32),
    # the CIFAR ResNet's global pool reads the global height; the 224²
    # one (the padded max pool, AvgPool 7) is ``test_resnet_224``'s
    "resnet18_cifar": ({}, {}, 32),
    "resnet18": ({}, {}, 224),
}
# the forward cases at M = 2 and 4 (the ResNet at 224² costs the most)
FORWARD = sorted(set(CASES) - {"resnet18"})
INTERVAL = ("tt_certif", "cifar10lownoise", "model_general")
_MODELS: dict = {}


def model_of(name: str):
    """``(ModelDef, model)``: f64 on the CPU, seeded, BN statistics
    perturbed so the Heaviside outputs are not a fresh init's."""
    if name not in _MODELS:
        kw, fields, _ = CASES[name]
        md = get_model(name, **kw)
        md = dataclasses.replace(md, config=dataclasses.replace(md.config,
                                                                **fields))
        model = md.init(seed=1, device="cpu", dtype=torch.float64)
        gen = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    n = m.running_mean.shape
                    m.running_mean.add_(0.05 * torch.randn(
                        n, generator=gen, dtype=torch.float64))
                    m.running_var.mul_(torch.exp(0.05 * torch.randn(
                        n, generator=gen, dtype=torch.float64)))
        _MODELS[name] = md, model
    return _MODELS[name]


def batch(name: str, seed: int, b: int | None = None) -> torch.Tensor:
    """Seeded images: two, one for the (wide) ResNets."""
    side = CASES[name][2]
    b = b or (1 if name.startswith("resnet") else 2)
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(b, side, side, 3)))


class Bits:
    """Every Heaviside output, by thread (each emulated rank's own)."""

    def __init__(self):
        self.by_thread = {}

    def __enter__(self):
        real = (binarize.heaviside01, binarize.heaviside01_noisy)

        def keep(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                self.by_thread.setdefault(threading.get_ident(), []).append(
                    out.detach().clone())
                return out
            return wrapped
        self.patches = [mock.patch.object(binarize, "heaviside01",
                                          keep(real[0])),
                        mock.patch.object(binarize, "heaviside01_noisy",
                                          keep(real[1]))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()

    def mine(self) -> list:
        return self.by_thread.get(threading.get_ident(), [])


def sharded(model, x, n, noise=None, bits=None):
    """Each rank's logits (and Heaviside outputs) of the sharded forward."""
    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        kw = {} if noise is None else {"noise": noise}
        with torch.no_grad():
            out = sp_forward(model, shard)(sp.local_rows(x, shard), **kw)
        return out, list(bits.mine()) if bits is not None else None
    return run_ranks(n, rank)


def unsharded(md, model, x, noise=None):
    kw = {"noise": noise} if md.stochastic else {}
    with torch.no_grad():
        return model(x, **kw)


def test_every_family_has_a_sharded_forward():
    """Each config type of ``_FAMILIES`` has its forward, and each but the
    ttnet_imagenet family (``tests/test_torch_sp.py``) a case here."""
    assert set(SP_FAMILIES) == set(_FAMILIES)
    assert {type(model_of(name)[0].config) for name in CASES} \
        == set(_FAMILIES) - {TTnetImageNetConfig}
    assert {c for c, f in SP_FAMILIES.items() if f.interval} == {
        type(model_of(name)[0].config) for name in INTERVAL}


def _assert_rows_equal(full: list, parts: list, n: int, m: int):
    assert len(parts) == len(full), "another number of Heaviside sites"
    for want, got in zip(full, parts):
        lo, hi = sp.row_bounds(want.shape[2], n, m)
        assert torch.equal(got[:, :, :hi - lo], want[:, :, lo:hi])


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("name", FORWARD)
def test_sharded_forward_equals_unsharded(name, n):
    md, model = model_of(name)
    x = batch(name, 3)
    noise = NoiseKey(7) if md.stochastic else None
    with Bits() as bits:
        want = unsharded(md, model, x, noise)
        full = list(bits.mine())
        got = sharded(model, x, n, noise, bits)
    for m, (logits, parts) in enumerate(got):
        assert logits.shape == want.shape
        assert torch.allclose(logits, want, rtol=0, atol=1e-12)
        _assert_rows_equal(full, parts, n, m)


def test_resnet_224():
    """``resnet18`` at 224² over four ranks (MaxPool(3, 2, 1) pads with
    -inf across the slices, AvgPool 7 reads the last 7 rows whole)."""
    md, model = model_of("resnet18")
    x = batch("resnet18", 5)
    want = unsharded(md, model, x)
    for logits, _ in sharded(model, x, 4):
        assert torch.allclose(logits, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("transform", (fuse_resnet, fold_model_bns),
                         ids=("fuse_quant", "fold_bn"))
def test_resnet_serving_transforms(transform):
    """``--fuse_quant`` and ``--fold_bn`` rewrite the weights before the
    ``--sp`` branch: the sharded forward of the rewritten ResNet equals
    its unsharded forward."""
    md, model = model_of("resnet18_cifar")
    model = copy.deepcopy(model)
    transform(model)
    x = batch("resnet18_cifar", 5)
    want = unsharded(md, model, x)
    for logits, _ in sharded(model, x, 2):
        assert torch.allclose(logits, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,per_forward", [
    ("TT_vf_19lv3_imgnet_xsmall_VGG", 1), ("TT_FHE_SMALL", 2)])
def test_fused_switch_on_each_ranks_rows(name, per_forward):
    """The k = 1 stride-1 heads (head 3, and the fuse head where there is
    one) take the fused wrapper on each rank's rows with the switch on;
    the logits equal the unsharded forward's with the switch on."""
    md, model = model_of(name)
    x = batch(name, 9)
    calls = []
    real = block_tt_module.fused_pointwise_nchw

    def counted(t, *a, **k):
        calls.append(t.shape[2])
        return real(t, *a, **k)

    saved = config.performance.fused_pointwise_blocks
    config.performance.fused_pointwise_blocks = True
    try:
        with mock.patch.object(block_tt_module, "fused_pointwise_nchw",
                               counted):
            want = unsharded(md, model, x)
            assert len(calls) == per_forward
            whole = sorted(calls)
            calls.clear()
            got = sharded(model, x, 2)
    finally:
        config.performance.fused_pointwise_blocks = saved
    assert len(calls) == 2 * per_forward
    # each rank's own rows of the whole heights
    assert sorted(calls) == sorted(c for h in whole
                                   for c in (-(-h // 2), h // 2))
    for logits, _ in got:
        assert torch.allclose(logits, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,n", [("TT_vf_19lv2_imgnet", 2),
                                    ("cifar10lownoise", 4)])
def test_sharded_input_gradient_equals_unsharded(name, n):
    """The cross-entropy's gradient with respect to the images (what
    ``--attack`` differentiates), each rank holding its rows."""
    md, model = model_of(name)
    x = batch(name, 11)
    labels = torch.tensor([1, 3])
    want = _loss_grad(model, x, labels)

    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        return _loss_grad(sp_forward(model, shard), sp.local_rows(x, shard),
                          labels)

    got = torch.cat(run_ranks(n, rank), dim=1)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-9 * scale


@pytest.mark.parametrize("n", (2, 4))
def test_row_noise_draws_the_global_rows(n):
    """A site's flips under ``--sp`` are the rows of the global draw from
    the same key; a rank with no rows (height 3 over 4) draws none."""
    key = NoiseKey(5).child(2)
    for h in (17, 3):
        want = key.draw(torch.zeros((2, 3, h, 5), dtype=torch.float64))
        for m in range(n):
            shard = sp.RowShard(n, m)
            lo, hi = shard.bounds(h)
            rows = torch.zeros((2, 3, max(1, hi - lo), 5),
                               dtype=torch.float64)
            got = sp.RowNoise(key, h, shard).draw(rows)
            assert got.shape == rows.shape
            if hi > lo:
                assert torch.equal(got, want[:, :, lo:hi])
            else:
                assert not got.any()


def _ball(x):
    return 2 / 255, 0.0, 1.0


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("name", INTERVAL)
def test_sharded_interval_logits_equal_unsharded(name, n):
    md, model = model_of(name)
    x = batch(name, 13, 4)
    want = md.interval_logits(model, x, *_ball(x))
    preds = unsharded(md, model, x, NoiseKey(3)).argmax(-1)

    def rank(m, group):
        shard = sp.RowShard(n, m, group)
        with torch.no_grad():
            return sp_interval_logits(model, shard)(
                sp.local_rows(x, shard), *_ball(x))

    mask = certified_mask(want, preds)
    for iv in run_ranks(n, rank):
        assert torch.allclose(iv.vmin, want.vmin, rtol=0, atol=1e-12)
        assert torch.allclose(iv.vmax, want.vmax, rtol=0, atol=1e-12)
        assert torch.equal(certified_mask(iv, preds), mask)


@pytest.mark.parametrize("name", INTERVAL)
def test_sharded_eval_step_certify_and_attack(name):
    """``make_eval_step(spatial=True)`` with ``--certify`` and ``--attack
    fgsm`` on a 1 x 2 mesh equals the unsharded step (``tt_certif`` keyed
    from one ``NoiseKey``, batch by batch)."""
    md, model = model_of(name)
    x = batch(name, 17, 4)
    labels = torch.tensor([0, 3, -1, 7])
    attack = {"kind": "fgsm", "eps": 2 / 255, "steps": 1, "step_size": None}
    kw = dict(md=md, model=model, certify_eps=2 / 255, attack=attack)
    noise = NoiseKey(9) if md.stochastic else None
    want = make_eval_step(model, noise=noise, **kw)(x, labels)

    def rank(m, group):
        mesh = Mesh(1, 2, m)
        mesh.model_group = group
        step = make_eval_step(sp_forward(model, sp.row_shard(mesh)),
                              noise=noise, mesh=mesh, spatial=True, **kw)
        return {k: float(v) for k, v in step(x, labels).items()}

    for got in run_ranks(2, rank):
        for k in ("loss", "top1", "top5", "n", "cert", "adv"):
            assert got[k] == pytest.approx(float(want[k]), rel=1e-12,
                                           abs=1e-12), k
