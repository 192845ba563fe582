"""The port's TT_FHE family against the JAX package on the CPU: the T = 0
models of ``FHE_MODELS`` at nfilter = tfilter = 4 (as
``tests/test_fhe_extras.py:157`` builds them) and ``TT_FHE_XSMALL_vAlexnet``
at its fixed p = 64, on 32x32 inputs; one JAX init feeds both sides
through ``convert/from_jax.py``.

Tolerances: f64 conv logits to 1e-9 (summation order only); truth tables,
packed words, covers, gate counts and every block bit exactly; the LUT and
gate logits equal to each other exactly, to the port's conv logits and to
JAX's LUT and gate logits within 1e-4 in f32 (the float stem and head sum
in another order); the state dict's keys and values equal
``export_tt_fhe``'s.  The CLI runs are in ``tests/test_torch_fhe_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, x64  # noqa: F401

from scale_imagenet_tpu import compile as jcompile
from scale_imagenet_tpu.compile import gate_net as jgate
from scale_imagenet_tpu.compile import lut_eval as jlut
from scale_imagenet_tpu.convert.torch_export import export_tt_fhe
from scale_imagenet_tpu.convert.torch_import import import_tt_fhe, \
    import_tt_fhe_alexnet
from scale_imagenet_tpu.models import get_model as jget
from scale_imagenet_tpu.models import multihead as jmh
from scale_imagenet_tpu.ops.poly import polynome_act as jpolynome_act
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.compile import gate_device, gate_net, \
    lut_eval, lut_store
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
from scale_imagenet_tpu_torch.kernels import lut_gather as K
from scale_imagenet_tpu_torch.models import get_model, list_models, \
    multihead
from scale_imagenet_tpu_torch.ops.poly import polynome_act

ALEX = "TT_FHE_XSMALL_vAlexnet"
FHE = ["TT_FHE_SMALL", "TT_FHE_XSMALL", "TT_FHE_ref",
       "TT_FHE_SMALL_polyhead", "TT_FHE_SMALL_bireal"]
ALL = FHE + [ALEX]
# the models whose stem emits bits, so that they have tables and circuits
TABLES = [n for n in ALL if n != "TT_FHE_SMALL_bireal"]
TOL = dict(rtol=1e-9, atol=1e-9)


def _kw(name):
    return {} if name == ALEX else dict(nfilter=4, tfilter=4)


def _width(name):
    return ["--model", name] + ([] if name == ALEX else
                                ["--nfilter", "4", "--tfilter", "4"])


def _family(name):
    """``(compile, LUT forward, gate compile, host gate forward)`` of a
    model in the JAX package."""
    if name == ALEX:
        return (jlut.compile_ttnet_lut, jlut.lut_tt_fhe_alexnet_apply,
                jgate.compile_ttnet_gates, jgate.gate_tt_fhe_alexnet_apply)
    return (jlut.compile_tt_fhe_lut, jlut.lut_tt_fhe_apply,
            jgate.compile_tt_fhe_gates, jgate.gate_tt_fhe_apply)


_CACHE: dict = {}


def fhe32(name, tables: bool = True):
    """One f32 JAX init on both sides (BN statistics perturbed), with each
    side's tables and covers (``tables``); built once a model."""
    if name not in _CACHE:
        jm, params, state, md, model = jax_and_port(name, np.float32, seed=3,
                                                    jit=True, **_kw(name))
        _CACHE[name] = dict(
            jm=jm, params=params, state=state, md=md, model=model,
            jp=jax.tree.map(jnp.asarray, params),
            js=jax.tree.map(jnp.asarray, state), fam=cli._family(md.config))
    f = _CACHE[name]
    if tables and "luts" not in f:
        jc, _, jgc, _ = _family(name)
        f.update(jluts=jc(f["jp"], f["js"], f["jm"].config),
                 luts=f["fam"].lut_compile(f["model"]),
                 jnets=jgc(f["params"], f["state"], f["jm"].config),
                 pnets=f["fam"].gate_compile(f["model"]))
    return f


def test_registry_and_configs_match_jax():
    """Names, block configs, feature shapes and fcsize equal JAX's, at the
    test width and at the full p = 64, the noisy TT_FHE_small's too
    (``tests/test_torch_noisy.py``)."""
    assert set(ALL + ["tt_fhe_small", "TT_FHE_small"]) <= set(list_models())
    for name in ALL + ["tt_fhe_small", "TT_FHE_small"]:
        for kw in (_kw(name), {}):
            md, jm = get_model(name, **kw), jget(name, **kw)
            assert md.name == jm.name
            assert md.config.fcsize == jm.config.fcsize
            if hasattr(jm.config, "feature_shape"):
                assert md.config.feature_shape() == jm.config.feature_shape()
            for b, jb in zip(md.config.block_configs(),
                             jm.config.block_configs(), strict=True):
                assert b.out_channels == jb.out_channels
                for h, hc in b.head_cfgs().items():
                    jh = jb.head_cfgs()[h]
                    assert (hc.k, hc.padding, hc.groupsici, hc.n_bits) == \
                        (jh.k, jh.padding, jh.groupsici, jh.n_bits)
                if b.fuse:
                    assert b.convf_cfg().groupsici == \
                        jb.convf_cfg().groupsici
    noisy = get_model("TT_FHE_small").config
    assert noisy.stochastic and not get_model("TT_FHE_SMALL").config.stochastic
    for b in noisy.block_configs():
        assert b.T == b.T_convf == 0.1
        assert all(h.T == 0.1 for h in b.head_cfgs().values())
        assert b.convf_cfg().T == 0.1


def test_fixups_and_poly_match_jax():
    for rule in ("fhe_v3", "fhe_valexnet"):
        for xw in (4, 6, 7, 8, 9, 10, 16, 17):
            for out1w in (xw - 1, xw, xw + 1, 4, 17):
                assert multihead.FIXUP_RULES[rule](xw, out1w) == \
                    jmh.FIXUP_RULES[rule](xw, out1w)
    x = (images((3, 8), 6) * 4 - 2).astype(np.float32)
    for k in (None, 5, 8, 100):
        np.testing.assert_allclose(
            polynome_act(torch.from_numpy(x), square_features=k).numpy(),
            np.asarray(jpolynome_act(jnp.asarray(x), square_features=k)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ALL)
def test_conv_logits_match_jax_f64(x64, name):  # noqa: F811
    jm, params, state, md, model = jax_and_port(name, np.float64, seed=5,
                                                jit=True, **_kw(name))
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    x = images((2, 32, 32, 3), 7)
    ref, _ = jax.jit(jm.apply)(jp, js, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", TABLES)
def test_tables_words_and_covers_match_jax(name):
    """Every head's table and packed words, and every filter's DNF and CNF
    covers, constants and gate count, equal JAX's."""
    f = fhe32(name)
    assert len(f["luts"]) == len(f["jluts"]) == len(f["md"].config
                                                     .block_configs())
    for tl, jl, pm, jn in zip(f["luts"], f["jluts"], f["pnets"],
                              f["jnets"]):
        pairs = [(tl.heads[i], jl.heads[i]) for i in tl.heads]
        if tl.convf is not None:
            pairs.append((tl.convf, jl.convf))
        for h, jh in pairs:
            np.testing.assert_array_equal(
                h.packed.numpy(), np.asarray(jh.packed).reshape(
                    h.packed.shape))
            np.testing.assert_array_equal(lut_store._table(h).numpy(),
                                          np.asarray(jh.table))
        assert pm.gates == jn.gates
        gpairs = [(pm.heads[i], jn.heads[i]) for i in pm.heads]
        if pm.convf is not None:
            gpairs.append((pm.convf, jn.convf))
        for bg, jb in gpairs:
            assert bg.constants == jb.constants
            for a, b in zip(bg.covers + bg.cnf_covers,
                            jb.covers + jb.cnf_covers, strict=True):
                np.testing.assert_array_equal(a, np.asarray(b, np.uint32))


@pytest.mark.parametrize("name", TABLES)
def test_lut_and_gate_logits_match(name):
    """The LUT forward against the port's conv forward and JAX's LUT
    forward; the host and device circuits (DNF and CNF) equal the LUT
    forward, block bits and logits, and JAX's circuits within 1e-4."""
    f = fhe32(name)
    model, fam, jm = f["model"], f["fam"], f["jm"]
    _, jlut_apply, _, jgate_host = _family(name)
    x = images((3, 32, 32, 3), 8).astype(np.float32)
    xt = torch.from_numpy(x)
    K.reset_launches()
    GC.reset_launches()
    got = fam.lut(f["luts"], model, xt)
    ref = jlut_apply(f["jluts"], f["jp"], f["js"], jm.config, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(got, fam.conv(model, xt), rtol=1e-4,
                                   atol=1e-4)
    for form in ("dnf", "cnf"):
        gdevs = gate_device.build_device_gates(f["pnets"], form)
        host = fam.gate_host(f["pnets"], model, xt, form=form)
        dev = fam.gate_device(gdevs, model, xt)
        assert torch.equal(host, got) and torch.equal(dev, got)
        want = jgate_host(f["jnets"], f["jp"], f["js"], jm.config,
                          jnp.asarray(x), form=form)
        np.testing.assert_allclose(dev.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        for tl, pm, gd in zip(f["luts"], f["pnets"], gdevs):
            # block bits, from random bits of the block's input width
            h = torch.from_numpy((images((2, tl.cfg.in_planes, 9, 9), 9)
                                  < 0.5).astype(np.float32))
            want = lut_eval.lut_multihead_apply(tl, h)
            assert torch.equal(gate_net.gate_multihead_apply(
                pm, h, form=form), want)
            assert torch.equal(gate_device.gate_multihead_apply_device(
                gd, h), want)
    # the CPU runs the plain versions: no kernel launch
    assert K.lut_window_bits.launches == GC.gate_cubes.launches == 0


def test_bireal_refuses_tables_and_circuits_as_jax():
    f = fhe32("TT_FHE_SMALL_bireal", tables=False)
    jm, params, state, model = f["jm"], f["params"], f["state"], f["model"]
    fam = f["fam"]
    for port, jfn in ((fam.lut_compile, jlut.compile_tt_fhe_lut),
                      (fam.gate_compile, jgate.compile_tt_fhe_gates)):
        with pytest.raises(ValueError) as jerr:
            jfn(params, state, jm.config)
        with pytest.raises(ValueError) as err:
            port(model)
        assert str(err.value) == str(jerr.value) and "Bi-Real" in str(
            err.value)


@pytest.mark.parametrize("name", ALL)
def test_state_dict_is_jax_export_and_import(name):
    """The port's state dict has ``export_tt_fhe``'s keys and values
    (vAlexnet: JAX's importer reads it back into the same trees);
    ``jax_trees`` inverts it and the LUT digests agree."""
    f = fhe32(name, tables=False)
    jm, params, state, model = f["jm"], f["params"], f["state"], f["model"]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if name == ALEX:
        ip, ist = import_tt_fhe_alexnet(sd, jm.config)
    else:
        want = export_tt_fhe(params, state, jm.config)
        assert sorted(sd) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(sd[k], np.asarray(v), err_msg=k)
        ip, ist = import_tt_fhe(sd, jm.config)
    for a, b in ((ip, params), (ist, state), *zip(jax_trees(model),
                                                  (params, state))):
        assert jax.tree_util.tree_structure(jax.tree.map(np.asarray, a)) \
            == jax.tree_util.tree_structure(b)
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, a), b)
    assert lut_store.model_digest(model) == jcompile.params_digest(params,
                                                                  state)
