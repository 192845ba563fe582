"""The port's v2 TTnet (``ttnet_imagenet_v2`` = ``TT_vf_19lv3_imgnet``)
against the JAX package on the CPU, at p = 32 (the smallest width whose
head 3 exists, ``tests/test_registry_shapes.py:33``), 224x224 inputs and
B = 2; one JAX init feeds both sides through ``convert/from_jax.py``.

Tolerances: f64 logits and two f64 train steps to 1e-9 (summation order
only); block output sizes, repaired group counts and refusal texts equal
JAX's; the fused pointwise plain version at v2's shapes (ci = 32, co 32
and 16, m = 256) equal to JAX's Pallas kernel in interpret mode for
Heaviside outputs, and within 1e-5 for ReLU ones.
"""

import copy
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, jax_train_steps, tree_np
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.convert.torch_export import \
    export_ttnet_imagenet as jexport
from scale_imagenet_tpu.models import get_model as jget
from scale_imagenet_tpu.models import multihead as jmh
from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg, \
    init_block_tt
from scale_imagenet_tpu.pallas import fused_block as jfb
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.convert.from_jax import _bn, _conv
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.models import get_model, multihead
from scale_imagenet_tpu_torch.models.block_tt import BlockTT, BlockTTConfig
from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, stem, \
    ttnet_imagenet_apply
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

NAME = "ttnet_imagenet_v2"
KW = dict(nfilter=4, tfilter=8, layers=1)
WIDTH = ["--model", NAME, "--nfilter", "4", "--tfilter", "8"]
TOL = dict(rtol=1e-9, atol=1e-9)


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def v2_64(x64_module):
    """One f64 JAX init on both sides (BN statistics perturbed)."""
    return jax_and_port(NAME, np.float64, seed=2, jit=True, **KW)


def _groups(cfgs):
    return [(b.head_cfgs()[3].groupsici, b.convf_cfg().groupsici,
             b.out_channels) for b in cfgs]


def test_registry_repaired_groups_and_sizes():
    """Both names; the group counts stepped down where ``int(cin/30)``
    does not divide the channels, the block sizes and fcsize, all equal
    JAX's at p = 32 and at the full p = 64."""
    for name in (NAME, "TT_vf_19lv3_imgnet"):
        for kw in (KW, dict(nfilter=8, tfilter=8, layers=1)):
            cfg, jcfg = get_model(name, **kw).config, jget(name, **kw).config
            assert _groups(cfg.block_configs()) == \
                _groups(jcfg.block_configs())
            h = w = 56
            for b, jb in zip(cfg.block_configs(), jcfg.block_configs()):
                assert b.repair_groups and b.fixup == "v2"
                assert multihead.multihead_out_size(b, h, w) == \
                    jmh.multihead_out_size(jb, h, w)
                h, w = multihead.multihead_out_size(b, h, w)
            assert cfg.feature_shape() == jcfg.feature_shape()
            assert cfg.fcsize == jcfg.fcsize
    # p = 64: head 3 and the fuse heads take ci = 32 in every block
    full = get_model(NAME, nfilter=8, tfilter=8).config.block_configs()
    assert _groups(full) == [(2, 8, 128), (4, 16, 256), (8, 32, 1024)]
    assert {b.convf_cfg().in_planes // b.convf_cfg().groupsici
            for b in full} == {32}


def test_invalid_width_and_disabled_heads_raise_as_jax():
    """Without ``repair_groups`` an invalid width raises, and a disabled
    head is refused, with JAX's words."""
    kw = dict(in_planes=512, out_planes=256, k12=((6, 5), (5, 6)),
              pad12=(3, 3), groups=(1, 1, 30, 1), groupvf=30, fixup="v2")
    errs = []
    for mod in (multihead, jmh):
        with pytest.raises(ValueError) as err:
            mod.MultiHeadConfig(**kw).head_cfgs()
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "repair_groups" in errs[0]
    errs = []
    for mod in (multihead, jmh):
        with pytest.raises(ValueError) as err:
            mod.MultiHeadConfig(**{**kw, "groups": (1, None, 16, 1)})
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "disabled heads" in errs[0]


def test_fixup_v2_matches_jax():
    for xw in (56, 58, 29, 30, 16, 9, 8, 4):
        for out1w in (xw, xw + 1, xw + 2, 6, 29, 58):
            assert multihead.FIXUP_RULES["v2"](xw, out1w) == \
                jmh.FIXUP_RULES["v2"](xw, out1w)


def test_conv_logits_and_block_sizes_match_jax_f64(v2_64):
    """Logits to 1e-9 at 224^2, and every block's output size as JAX's
    ``multihead_out_size`` gives it."""
    jm, params, state, md, model = v2_64
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    x = images((2, 224, 224, 3), 3)
    ref, _ = jax.jit(jm.apply)(jp, js, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(
            ttnet_imagenet_apply(model, xt).numpy(), np.asarray(ref), **TOL)
        h = stem(model, _nchw(xt, model))
        for block, bcfg in zip(model.blocks, jm.config.block_configs()):
            size = jmh.multihead_out_size(bcfg, *h.shape[2:])
            h = block(h)
            assert h.shape[1:] == (bcfg.out_channels, *size)
            assert bcfg.last or set(h.unique().tolist()) == {0.0, 1.0}


def _block(kw, seed):
    """A JAX ``init_block_tt`` and the port's ``BlockTT`` with the same f32
    weights, BN statistics moved off their defaults."""
    p, s = init_block_tt(jax.random.PRNGKey(seed), JBlockCfg(**kw))
    s = jax.tree.map(lambda a: a + 0.1, s)
    p, s = tree_np(p, np.float32), tree_np(s, np.float32)
    block = BlockTT(BlockTTConfig(**kw)).eval()
    sd = {"conv1.weight": _conv(p["conv1"]["weight"]),
          "conv2.weight": _conv(p["conv2"]["weight"]),
          "act.grad_scale": torch.tensor(1.0)}
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    _bn(sd, "bn2", p["bn2"], s["bn2"])
    block.load_state_dict(sd, strict=True)
    return JBlockCfg(**kw), p, s, block


# v2's k=1 launches at p = 64: head 3 (ci = co = 32), the fuse heads of
# blocks 0 and 1 (ci = 32, co = 16) and the last block's ReLU fuse head
V2_FUSED = {"head3": dict(in_planes=64, out_planes=64, groupsici=2),
            "fuse": dict(in_planes=256, out_planes=128, groupsici=8),
            "last_fuse": dict(in_planes=256, out_planes=256, groupsici=8,
                              last=True)}


@pytest.mark.parametrize("shape", list(V2_FUSED))
def test_fused_plain_matches_jax_interpret(shape):
    """The plain version at (ci, co, m) = (32, 32, 256) and (32, 16, 256)
    against JAX's ``fused_block_tt_pointwise_v2`` in interpret mode."""
    kw = dict(k=1, padding=0, **V2_FUSED[shape])
    cfg, p, s, block = _block(kw, seed=len(shape))
    g, ci, m = block.pointwise_params()[0].shape
    assert (ci, m) == (32, 256) and block.pointwise_params()[3].shape[2] \
        == cfg.out_planes // g
    x = (images((2, 3, 3, cfg.in_planes), 5) < 0.5).astype(np.float32)
    ref = np.asarray(jfb.fused_block_tt_pointwise_v2(
        p, s, cfg, jnp.asarray(x), interpret=True))
    with torch.no_grad():
        got = FB.fused_block_tt_pointwise_v2(block, torch.from_numpy(x))
    if cfg.last:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_fused_switch_routes_every_k1_block(v2_64, monkeypatch):
    """With the switch on, each of the 6 k=1 blocks goes through the fused
    wrapper (its plain version on the CPU), at ci = 32; the logits keep
    the unfused forward's within the polynomial erf's flips."""
    model = v2_64[4]
    shapes = []
    real = FB.fused_pointwise_block_plain

    def rec(x, w1, *rest, **kw):
        shapes.append((w1.shape[1], rest[2].shape[2]))
        return real(x, w1, *rest, **kw)
    monkeypatch.setattr(FB, "fused_pointwise_block_plain", rec)
    m32 = copy.deepcopy(model).float()
    x = torch.from_numpy(images((2, 224, 224, 3), 4).astype(np.float32))
    with torch.no_grad():
        ref = ttnet_imagenet_apply(m32, x)
        monkeypatch.setattr(config.performance, "fused_pointwise_blocks",
                            True)
        got = ttnet_imagenet_apply(m32, x)
    assert shapes == [(32, 32), (32, 16), (32, 32), (32, 16), (32, 32),
                      (32, 32)]
    assert torch.equal(got.argmax(1), ref.argmax(1))


def test_two_train_steps_match_jax(v2_64):
    """Two f64 steps of the port's ``make_train_step`` against JAX's: loss,
    top-1/5, every parameter and BN statistic to 1e-9."""
    jm, params, state, md, model0 = v2_64
    rng = np.random.default_rng(5)
    batches = [(images((2, 224, 224, 3), s),
                rng.integers(0, 1000, 2).astype(np.int32)) for s in (6, 7)]
    opt_kw = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
    tx, _ = jmake_optimizer(**opt_kw)
    jparams, jstate, jmetrics, _ = jax_train_steps(jm, tx, params, state,
                                                   batches)
    model = get_model(NAME, **KW).init(device="cpu", dtype=torch.float64)
    model.load_state_dict(model0.state_dict())
    opt, _ = make_optimizer(**opt_kw)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for (x, y), jm_ in zip(batches, jmetrics):
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y))
        for k, v in jm_.items():
            np.testing.assert_allclose(float(m[k]), v, **TOL, err_msg=k)
    got_p, got_s = jax_trees(ts.model)
    for got, want in ((got_p, jparams), (got_s, jstate)):
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat) == len(jax.tree.leaves(got))
        for path, w in flat:
            g = got
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                       err_msg=jax.tree_util.keystr(path))


def test_export_and_ckpt_round_trip(v2_64, tmp_path):
    """``--mode export`` writes JAX's ``export_ttnet_imagenet`` keys and
    values; ``--ckpt`` of that file loads strict and gives the same
    logits."""
    jm, params, state, md, model = v2_64
    m32 = copy.deepcopy(model).float()
    src = str(tmp_path / "src.pth")
    torch.save(m32.state_dict(), src)
    out = str(tmp_path / "exported.pth")
    with redirect_stdout(io.StringIO()):
        cli.main(["--mode", "export", "--device", "cpu", "--ckpt", src,
                  "--export_out", out, *WIDTH])
    sd = torch.load(out, weights_only=True)["model_state_dict"]
    want = jexport(tree_np(params, np.float32), tree_np(state, np.float32),
                   jm.config)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    again = get_model(NAME, **KW).init(device="cpu")
    cli.load_checkpoint(again, out)
    x = torch.from_numpy(images((1, 224, 224, 3), 8).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(ttnet_imagenet_apply(again, x),
                           ttnet_imagenet_apply(m32, x))


@pytest.mark.parametrize("argv", [
    ["--mode", "eval", "--shards_dir", "d", "--lut"],
    ["--mode", "eval", "--shards_dir", "d", "--gates", "dnf"],
    ["--mode", "compile"],
], ids=["lut", "gates", "compile"])
def test_tables_refused_as_jax(argv, tmp_path):
    """Heads 1 and 2 see n = 30 bits, above the enumeration limit of 24 in
    both packages: ``--lut``, ``--gates`` and ``--mode compile`` raise the
    JAX CLI's error."""
    out = ["--compile_out", str(tmp_path / "tt"), "--root_dir",
           str(tmp_path)]
    with pytest.raises(ValueError) as jerr, redirect_stdout(io.StringIO()):
        jmain.main(argv + WIDTH + out + ["--mesh_data", "1"])
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + WIDTH + out + ["--device", "cpu"])
    assert str(err.value) == str(jerr.value) == \
        "n=30 bits: 2^n enumeration infeasible"
