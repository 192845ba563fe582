"""The port's gate compiler against the JAX package: the native binding,
minimization and its artifacts, the compiled covers, the host evaluator and
the device evaluator (``kernels/gate_cubes.py``'s plain version on the
CPU), at small sizes from seeded numpy inputs.

Tolerances: none.  Covers, gate counts, DIMACS text, circuit sizes and
every gate bit must be equal.  The blocks are f32 on both sides (the JAX
enumerator feeds f32 patterns); both compilers enumerate the same tables
from them at these sizes, which the equal covers show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import block_from_jax

import scale_imagenet_tpu.native as jnative
from scale_imagenet_tpu.compile import gate_device as jdev
from scale_imagenet_tpu.compile import gate_net as jgate
from scale_imagenet_tpu.compile import logic as jlogic
from scale_imagenet_tpu.models.block_tt import BlockTTConfig as JBlockCfg
from scale_imagenet_tpu_torch import native
from scale_imagenet_tpu_torch.compile import gate_device, gate_net, logic
from scale_imagenet_tpu_torch.compile.lut_eval import compile_block_tt_lut, \
    lut_block_tt_apply
from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
from scale_imagenet_tpu_torch.native import ttlogic

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

# (config, input NHWC shape): k = 1 grouped, k = 2 depthwise with pad 1,
# k = 2 strided over groups of 2 channels, k = 1 with n = 8
BLOCKS = [
    (dict(in_planes=16, out_planes=16, k=1, padding=0, groupsici=4),
     (3, 7, 7, 16)),
    (dict(in_planes=8, out_planes=8, k=2, padding=1, groupsici=8),
     (2, 6, 5, 8)),
    (dict(in_planes=8, out_planes=8, k=2, padding=1, stride=2, groupsici=4),
     (2, 9, 9, 8)),
    (dict(in_planes=16, out_planes=8, k=1, padding=0, groupsici=2),
     (2, 5, 6, 16)),
]
IDS = ["k1_grouped", "k2_depthwise_pad1", "k2_strided", "k1_n8"]


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _blocks(i: int, constants: bool = False):
    """``(jax BlockGates, port BlockGates, port BlockTT, input bits)``
    from one seeded init, f32; with ``constants`` filters 0 and 3 are
    pinned to 1 and 0 (BN2 scale 0, bias +-5), as
    ``tests/test_gate_net.py`` pins them."""
    kw, shape = BLOCKS[i]
    p, s, block = block_from_jax(kw, 10 + i, np.float32)
    if constants:
        p = jax.tree.map(np.array, p)
        for f, bias in ((0, 5.0), (3, -5.0)):
            p["bn2"]["weight"][f] = 0.0
            p["bn2"]["bias"][f] = bias
            block.bn2.weight.data[f] = 0.0
            block.bn2.bias.data[f] = bias
    jbg = jgate.compile_block_gates(_jtree(p), _jtree(s), JBlockCfg(**kw))
    pbg = gate_net.compile_block_gates(block)
    x = (np.random.default_rng(i).uniform(size=shape) < 0.5).astype(
        np.float32)
    return jbg, pbg, block, x


def _nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _assert_same_gates(jbg, pbg):
    assert pbg.constants == jbg.constants
    assert pbg.gates == jbg.gates
    for a, b in zip(jbg.covers + jbg.cnf_covers,
                    pbg.covers + pbg.cnf_covers):
        assert b.dtype == np.uint32
        np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------- binding

@pytest.mark.parametrize("n", [3, 6, 9, 12])
def test_binding_matches_the_jax_binding(n):
    rng = np.random.default_rng(n)
    col = (rng.random(1 << n) < 0.4).astype(np.uint8)
    packed = native.pack_table_bits(col)
    np.testing.assert_array_equal(packed, jnative.pack_table_bits(col))
    idx = rng.integers(0, 1 << n, 50)
    np.testing.assert_array_equal(native.eval_packed_table(packed, idx),
                                  jnative.eval_packed_table(packed, idx))
    minterms = np.nonzero(col)[0].tolist()
    for fn in ("espresso_cover", "expand_cover"):
        terms = getattr(native, fn)(packed, n)
        assert terms == getattr(jnative, fn)(packed, n)
        assert native.verify_cover(packed, terms, n) == 0 == \
            jnative.verify_cover(packed, terms, n)
        assert native.count_term_gates(terms, n) == \
            jnative.count_term_gates(terms, n)
        assert native.terms_to_dnf(terms, n) == \
            jnative.terms_to_dnf(terms, n)
    assert native.verify_cover(packed, terms[:-1], n) == \
        jnative.verify_cover(packed, terms[:-1], n) > 0
    if n <= 9:
        assert native.minimize_terms(minterms, n) == \
            jnative.minimize_terms(minterms, n)
    # bit-sliced evaluation of several covers, one of them empty
    covers = [np.asarray(native.espresso_cover(native.pack_table_bits(
        (rng.random(1 << n) < q).astype(np.uint8)), n), np.uint32)
        for q in (0.2, 0.5, 0.0)]
    planes = rng.integers(0, 2 ** 63, (n, 5), dtype=np.uint64)
    got = native.eval_covers(planes, covers, n)
    np.testing.assert_array_equal(got, jnative.eval_covers(planes, covers,
                                                           n))
    assert got.dtype == np.uint64 and not got[2].any()
    assert native.count_term_gates([], n) == 0


def test_binding_builds_into_build_native_and_raises_on_failure(
        tmp_path, monkeypatch):
    path = ttlogic.library_path()
    assert path.parent == ttlogic.BUILD_DIR
    assert ttlogic.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("libttlogic-") and path.suffix == ".so"
    bad = tmp_path / "ttlogic.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ttlogic, "SRC", bad)
    monkeypatch.setattr(ttlogic, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ttlogic, "_lib", None)
    with pytest.raises(RuntimeError, match="g.. failed to build"):
        native.pack_table_bits([1, 0])


# ------------------------------------------------------------ minimizing

@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_minimize_truth_table_and_strings_match_jax(n):
    rng = np.random.default_rng(20 + n)
    minterms = sorted(set(rng.integers(0, 1 << n, max(1, 1 << (n - 1)))
                          .tolist()))
    got = logic.minimize_truth_table(minterms, n)
    assert got == jlogic.minimize_truth_table(minterms, n)
    assert logic.count_gates(got["dnf"]) == jlogic.count_gates(got["dnf"])
    assert logic.cnf_with_output_literal(got["dnf"], got["cnf"]) == \
        got["cnf_y"]
    assert logic.dimacs_from_minterms(minterms, n, comment="c") == \
        jlogic.dimacs_from_minterms(minterms, n, comment="c")
    terms = native.minimize_terms(minterms, n)
    comp = native.minimize_terms(
        sorted(set(range(1 << n)) - set(minterms)) or [0], n)
    assert logic.dimacs_from_covers(terms, comp, n) == \
        jlogic.dimacs_from_covers(terms, comp, n)
    assert logic._terms_to_cnf(comp, n) == jlogic._terms_to_cnf(comp, n)


def test_minimize_sympy_engine_and_packed_match_jax():
    minterms = [0, 3, 5, 6, 7]
    assert logic.minimize_truth_table(minterms, 3, engine="sympy") == \
        jlogic.minimize_truth_table(minterms, 3, engine="sympy")
    with pytest.raises(ValueError, match="engine"):
        logic.minimize_truth_table(minterms, 3, engine="other")
    col = (np.random.default_rng(1).random(1 << 13) < 0.3).astype(np.uint8)
    packed = native.pack_table_bits(col)
    assert logic.minimize_packed(packed, 13) == \
        jlogic.minimize_packed(packed, 13)


# -------------------------------------------------------------- compiling

@pytest.mark.parametrize("i", range(len(BLOCKS)), ids=IDS)
def test_compile_block_gates_matches_jax(i):
    jbg, pbg, _, _ = _blocks(i)
    _assert_same_gates(jbg, pbg)
    assert pbg.gates > 0 and None in pbg.constants


def test_compile_block_gates_constant_filters_match_jax():
    jbg, pbg, _, _ = _blocks(0, constants=True)
    _assert_same_gates(jbg, pbg)
    assert pbg.constants[0] == 1.0 and pbg.constants[3] == 0.0
    assert len(pbg.covers[0]) == 0 == len(pbg.cnf_covers[3])


def test_float_block_is_refused_with_the_jax_message():
    kw = dict(in_planes=8, out_planes=8, k=1, padding=0, groupsici=4,
              last=True)
    p, s, block = block_from_jax(kw, 6, np.float32)
    with pytest.raises(ValueError) as jerr:
        jgate.compile_block_gates(_jtree(p), _jtree(s), JBlockCfg(**kw))
    with pytest.raises(ValueError) as err:
        gate_net.compile_block_gates(block)
    assert str(err.value) == str(jerr.value)
    assert "float-valued" in str(err.value)


def test_thread_pool_equals_one_thread():
    _, pbg, block, _ = _blocks(3)
    one = gate_net.compile_block_gates(block, threads=1)
    many = gate_net.compile_block_gates(block, threads=5)
    for bg in (one, many):
        assert bg.gates == pbg.gates and bg.constants == pbg.constants
        for a, b in zip(pbg.covers + pbg.cnf_covers,
                        bg.covers + bg.cnf_covers):
            np.testing.assert_array_equal(b, a)
    jobs = list(range(40))
    assert logic.map_in_order(lambda j: j * j, jobs, threads=7) == \
        [j * j for j in jobs]


# ------------------------------------------------------------- evaluating

@pytest.mark.parametrize("i", range(len(BLOCKS)), ids=IDS)
@pytest.mark.parametrize("form", ["dnf", "cnf"])
def test_host_and_device_evaluators_match_jax(i, form):
    """The host evaluator and the device evaluator (the kernel's plain
    version on the CPU) against JAX's ``gate_block_apply`` and
    ``gate_block_apply_device``: equal bits, f32 and bf16 inputs."""
    jbg, pbg, _, x = _blocks(i)
    jhost = np.asarray(jgate.gate_block_apply(jbg, jnp.asarray(x), form))
    jdv = np.asarray(jax.jit(jdev.gate_block_apply_device)(
        jdev.build_device_block(jbg, form), jnp.asarray(x)))
    np.testing.assert_array_equal(jdv, jhost)
    dev = gate_device.build_device_block(pbg, form)
    for dtype in (torch.float32, torch.bfloat16):
        host = gate_net.gate_block_apply(pbg, _nchw(x, dtype), form)
        got = gate_device.gate_block_apply_device(dev, _nchw(x, dtype))
        assert host.dtype == got.dtype == dtype
        np.testing.assert_array_equal(_nhwc(host), jhost)
        np.testing.assert_array_equal(_nhwc(got), jhost)


@pytest.mark.parametrize("form", ["dnf", "cnf"])
def test_evaluators_with_constant_filters_match_jax(form):
    jbg, pbg, _, x = _blocks(0, constants=True)
    jhost = np.asarray(jgate.gate_block_apply(jbg, jnp.asarray(x), form))
    host = gate_net.gate_block_apply(pbg, _nchw(x), form)
    got = gate_device.gate_block_apply_device(
        gate_device.build_device_block(pbg, form), _nchw(x))
    np.testing.assert_array_equal(_nhwc(host), jhost)
    np.testing.assert_array_equal(_nhwc(got), jhost)
    assert (jhost[..., 0] == 1).all() and (jhost[..., 3] == 0).all()


def test_gate_bits_equal_lut_bits():
    """Both are exact forms of the same truth table."""
    for i in range(len(BLOCKS)):
        _, pbg, block, x = _blocks(i)
        lut = lut_block_tt_apply(compile_block_tt_lut(block),
                                 _nchw(x))
        for form in ("dnf", "cnf"):
            torch.testing.assert_close(
                gate_net.gate_block_apply(pbg, _nchw(x), form), lut,
                rtol=0, atol=0)


@pytest.mark.parametrize("form", ["dnf", "cnf"])
def test_plain_cube_words_equal_jax_out_words(form, monkeypatch):
    """``gate_cubes_plain`` returns JAX's ``(G, F, W)`` out_words bit for
    bit, tail bits and constant filters included, whatever its chunk."""
    jbg, pbg, _, x = _blocks(0, constants=True)
    jd = jdev.build_device_block(jbg, form)
    planes, _, _ = jdev._pack_planes_device(jnp.asarray(x), jbg.cfg)
    mism = jnp.zeros(jd.e_const.shape[:3] + (planes.shape[-1],), jnp.int32)
    for p in range(jd.e_const.shape[-1]):
        mism = mism | ((planes[:, None, None, p, :]
                        ^ jd.e_const[..., p, None]) & jd.c_const[..., p, None])
    want = np.bitwise_or.reduce(np.asarray(~mism & jd.valid[..., None]),
                                axis=2)
    if form == "cnf":
        want = ~want
    pplanes, _, e = gate_device._pack_planes_device(_nchw(x), pbg.cfg)
    np.testing.assert_array_equal(pplanes.numpy(), np.asarray(planes))
    assert e % 32                       # a ragged last word
    dev = gate_device.build_device_block(pbg, form)
    for chunk in (GC.PLAIN_CHUNK_BYTES, 1):
        monkeypatch.setattr(GC, "PLAIN_CHUNK_BYTES", chunk)
        got = GC.gate_cubes_plain(pplanes, dev.cubes, dev.offsets, 4,
                                  form == "cnf")
        np.testing.assert_array_equal(got.numpy(), want)
    assert GC.gate_cubes(pplanes, dev.cubes, dev.offsets, 4,
                         form == "cnf").dtype == torch.int32


def test_gate_cubes_refuses_bad_shapes():
    planes = torch.zeros((2, 4, 3), dtype=torch.int32)
    cubes = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="offsets"):
        GC.gate_cubes(planes, cubes, torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="planes"):
        GC.gate_cubes(planes.long(), cubes,
                      torch.zeros(5, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="cubes"):
        GC.gate_cubes(planes, cubes[:, :1], torch.zeros(5, dtype=torch.int64),
                      2)


# ---------------------------------------------------------------- sizing

def test_circuit_device_bytes_and_budget_match_jax():
    """``circuit_device_bytes`` is JAX's padded count and equals JAX's.  The
    budget is held against the port's own bytes (``device_bytes``), which
    is not JAX's rule: a circuit over a small budget by JAX's count but not
    by the port's is built on the device and runs there (the kernel's
    plain version here), equal to the host circuit, where JAX refuses it;
    one over the budget by the port's count is refused with the port's
    text."""
    jbgs, pbgs, xs = [], [], []
    for i in range(len(BLOCKS)):
        jbg, pbg, _, x = _blocks(i)
        for form in ("dnf", "cnf"):
            assert gate_device.circuit_device_bytes(pbg, form) == \
                jdev.circuit_device_bytes(jbg, form)
        jbgs.append(jbg)
        pbgs.append(pbg)
        xs.append(_nchw(x))
    jnets = [jgate.MultiHeadGates(cfg=None, heads={1: jbgs[0], 2: jbgs[1]},
                                  convf=jbgs[2], gates=0)]
    pnets = [gate_net.MultiHeadGates(cfg=None, heads={1: pbgs[0],
                                                      2: pbgs[1]},
                                     convf=pbgs[2], gates=0)]
    padded = sum(gate_device.circuit_device_bytes(b) for b in pbgs[:3])
    need = sum(gate_device.device_bytes(b) for b in pbgs[:3])
    assert need < padded - 1
    # over the budget by JAX's padded count, within it by the port's
    with pytest.raises(ValueError):
        jdev.build_device_gates(jnets, "dnf", max_cube_bytes=padded - 1)
    for budget in (need, padded - 1):
        built = gate_device.build_device_gates(pnets, "dnf",
                                               max_cube_bytes=budget)
        for dev, bg, x in zip([built[0].heads[1], built[0].heads[2],
                               built[0].convf], pbgs, xs):
            torch.testing.assert_close(
                gate_device.gate_block_apply_device(dev, x),
                gate_net.gate_block_apply(bg, x), rtol=0, atol=0)
    # over it by the port's count: refused, and the text says which count
    for budget in (16, need - 1):
        with pytest.raises(ValueError) as err:
            gate_device.build_device_gates(pnets, "dnf",
                                           max_cube_bytes=budget)
        assert f"{need:,} bytes of covers on the card" in str(err.value)
        assert "not JAX's padded cube tensors" in str(err.value)
        assert "host evaluator" in str(err.value)
    built = gate_device.build_device_gates(pnets, "cnf",
                                           max_cube_bytes=need * 4)
    assert built[0].convf.invert and built[0].heads[1].offsets[-1] == \
        sum(len(c) for c in pbgs[0].cnf_covers)


@pytest.mark.parametrize("i", range(len(BLOCKS)), ids=IDS)
def test_device_bytes_are_what_the_card_holds(i):
    """``device_bytes`` is the size of the tensors a ``BlockGatesDev``
    holds (cubes, offsets, constant mask and values), DNF and CNF, with
    constant filters."""
    _, pbg, _, _ = _blocks(i, constants=True)
    assert any(c is not None for c in pbg.constants)
    for form in ("dnf", "cnf"):
        dev = gate_device.build_device_block(pbg, form)
        held = sum(t.numel() * t.element_size() for t in (
            dev.cubes, dev.offsets, dev.const_mask, dev.const_val))
        assert gate_device.device_bytes(pbg, form) == held
