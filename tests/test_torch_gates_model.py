"""The port's gate circuits at the model level against the JAX package:
the compiled gate nets, ``gate_multihead_apply`` and ``gate_ttnet_apply``
(host and device), the LUT forward, the table cache and the Verilog
export, on ``ttnet_imagenet_xsmall`` (nfilter 4, tfilter 4, ``--layers
0``) on the CPU.

Tolerances: block bits, covers, gate counts and Verilog text are equal.
Logits agree to 1e-4, the tolerance of ``tests/test_gate_net.py:149``: the
blocks are bit-exact, and only the float parts (stem, the last float fuse
head, classifier) sum in another order; the last block's float output
agrees to 1e-5 for the same reason.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port

from scale_imagenet_tpu.compile import gate_device as jdev
from scale_imagenet_tpu.compile import gate_net as jgate
from scale_imagenet_tpu.compile import verilog as jverilog
from scale_imagenet_tpu_torch.compile import gate_device, gate_net, \
    truth_table, verilog
from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut, \
    lut_multihead_apply
from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, stem

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

KW = dict(nfilter=4, tfilter=4, layers=0)


@pytest.fixture(scope="module")
def xsmall():
    """One JAX init on both sides (f32, BN statistics perturbed), with
    each side's compiled gate nets."""
    torch.set_num_threads(1)
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_xsmall", np.float32, seed=2, jit=True, **KW)
    jnets = jgate.compile_ttnet_gates(params, state, jm.config)
    pnets = gate_net.compile_ttnet_gates(model)
    return jm, params, state, md, model, jnets, pnets


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_model_gate_nets_match_jax(xsmall):
    _, _, _, _, _, jnets, pnets = xsmall
    assert gate_net.total_gates(pnets) == jgate.total_gates(jnets) > 0
    for jm, pm in zip(jnets, pnets):
        assert pm.gates == jm.gates
        assert sorted(pm.heads) == sorted(jm.heads)
        assert (pm.convf is None) == (jm.convf is None)
        for jb, pb in [(jm.heads[i], pm.heads[i]) for i in jm.heads] + (
                [(jm.convf, pm.convf)] if jm.convf else []):
            assert pb.constants == jb.constants and pb.gates == jb.gates
            for a, b in zip(jb.covers + jb.cnf_covers,
                            pb.covers + pb.cnf_covers):
                np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("form", ["dnf", "cnf"])
@torch.no_grad()
def test_block_bits_and_logits_match_jax(xsmall, form):
    """Each block from the same input bits: the boolean block's bits are
    equal, the last block's float output within 1e-5; the full forwards'
    logits within 1e-4, host and device, and the port's device logits
    equal its host logits."""
    jm, params, state, md, model, jnets, pnets = xsmall
    rng = np.random.default_rng(4)
    for i, (jmg, pmg) in enumerate(zip(jnets, pnets)):
        cin = pmg.cfg.in_planes
        hw = 56 if i == 0 else 29
        x = (rng.uniform(size=(2, hw, hw, cin)) < 0.5).astype(np.float32)
        blk = f"block{i}"
        conv = (params[blk]["convf"], state[blk]["convf"]) \
            if jmg.convf is None else None
        want = np.asarray(jgate.gate_multihead_apply(
            jmg, jnp.asarray(x), form=form, convf_float=conv))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = gate_net.gate_multihead_apply(
            pmg, xt, form=form, convf_float=model.blocks[i].Block_convf)
        dev = gate_device.gate_multihead_apply_device(
            gate_device.build_device_gates([pmg], form)[0], xt,
            convf_float=model.blocks[i].Block_convf)
        torch.testing.assert_close(dev, got, rtol=0, atol=0)
        got = got.permute(0, 2, 3, 1).numpy()
        if pmg.convf is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
    x = images((2, 224, 224, 3), 5).astype(np.float32)
    jhost = np.asarray(jgate.gate_ttnet_apply(jnets, params, state,
                                              jm.config, x, form=form))
    jdv = np.asarray(jdev.gate_ttnet_apply_device(
        jdev.build_device_gates(jnets, form), params, state, jm.config, x))
    host = gate_net.gate_ttnet_apply(pnets, model, torch.from_numpy(x),
                                     form=form)
    dev = gate_device.gate_ttnet_apply_device(
        gate_device.build_device_gates(pnets, form), model,
        torch.from_numpy(x))
    torch.testing.assert_close(dev, host, rtol=0, atol=0)
    for want in (jhost, jdv):
        np.testing.assert_allclose(host.numpy(), want, rtol=1e-4,
                                   atol=1e-4)


def test_gate_forward_equals_lut_forward(xsmall):
    """Block for block from the stem's bits, gates == LUT (exact)."""
    _, _, _, _, model, _, pnets = xsmall
    luts = compile_ttnet_lut(model)
    x = torch.from_numpy(images((2, 224, 224, 3), 6).astype(np.float32))
    with torch.no_grad():
        h = stem(model, _nchw(x, model))
        for lut, mg, block in zip(luts, pnets, model.blocks):
            want = lut_multihead_apply(lut, h, convf_float=block.Block_convf)
            for form in ("dnf", "cnf"):
                got = gate_net.gate_multihead_apply(
                    mg, h, form=form, convf_float=block.Block_convf)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            h = want


def test_table_cache_memoizes(xsmall):
    model = xsmall[4]
    block = model.blocks[0].Block_conv3
    with truth_table.table_cache():
        a = truth_table.block_truth_table(block)
        assert truth_table.block_truth_table(block) is a
    b = truth_table.block_truth_table(block)
    assert b is not a and torch.equal(a, b)


def test_export_model_verilog_matches_jax(xsmall, tmp_path):
    jm, _, _, md, _, jnets, pnets = xsmall
    for include_cnf, form in ((True, "dnf"), (False, "cnf")):
        jdir, pdir = tmp_path / f"j{form}", tmp_path / f"p{form}"
        jman = jverilog.export_model_verilog(jnets, str(jdir), form=form,
                                             model_name=jm.name,
                                             include_cnf=include_cnf)
        pman = verilog.export_model_verilog(pnets, str(pdir), form=form,
                                            model_name=md.name,
                                            include_cnf=include_cnf)
        assert pman == jman
        assert pman["total_gates"] == gate_net.total_gates(pnets)
        want, got = _tree(str(jdir)), _tree(str(pdir))
        assert sorted(got) == sorted(want) and got == want


