"""Channel-group tensor parallelism (``scale_imagenet_tpu_torch/parallel/
tp.py``, ``parallel/mesh.py``) against the JAX package, in one process.

At ``tests/test_tp.py``'s sizes (p = 32, ``--layers 0``, 224²), JAX on the
conftest's 8 virtual CPU devices:

* ``local_config``'s widths and both refusals, and the port's refusal of
  the other families naming the ``AttributeError`` JAX's function meets;
* each model rank's sliced state dict equals the matching shard of JAX's
  ``shard_params_tp`` exactly, and gathering the slices gives the whole
  model back;
* each rank's local features (f64) are its contiguous slice of the whole
  model's and of JAX's global features: the local interleave is the
  global slice;
* each rank's LUT tables (sliced from the whole model's, the port's route)
  equal the tables compiled from its local module and JAX's
  ``shard_luts_tp`` shards: bit words exactly, the last block's float
  table to the 1e-6 of compiling it in two frameworks (queue C);
* the row-parallel sum's backward is the identity, on a fake two-member
  group;
* the mesh's rank <-> (data, model) layout and its messages equal JAX's
  ``make_mesh``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_port import few_threads, images, jax_and_port  # noqa: F401

from scale_imagenet_tpu.compile import lut_eval as jlut
from scale_imagenet_tpu.models import get_model as jget_model
from scale_imagenet_tpu.models.ttnet_imagenet import \
    ttnet_imagenet_features as jfeatures
from scale_imagenet_tpu.parallel import mesh as jmesh
from scale_imagenet_tpu.parallel import tp as jtp
from scale_imagenet_tpu_torch.compile import lut_eval
from scale_imagenet_tpu_torch.convert import state_dict_from_jax
from scale_imagenet_tpu_torch.kernels import lut_gather as K
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    ttnet_imagenet_features
from scale_imagenet_tpu_torch.parallel import tp
from scale_imagenet_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.usefixtures("few_threads", "x64_module")

P32 = dict(nfilter=8, tfilter=4, layers=0)
N_MODEL = 2


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_mesh(data, model):
    return jmesh.make_mesh(data, model,
                           devices=jax.devices()[:data * model])


def _shard_of(tree, mesh: Mesh, m: int):
    """Model index ``m``'s blocks of a sharded JAX tree (data index 0)."""
    dev = mesh.devices[0, m]

    def pick(a):
        for s in a.addressable_shards:
            if s.device == dev:
                return np.asarray(s.data)
        raise AssertionError("no shard on the device")
    return jax.tree.map(pick, tree)


# ------------------------------------------------------- local_config

@pytest.mark.parametrize("name,kw,n", [
    ("ttnet_imagenet_small", P32, 2),
    ("ttnet_imagenet_small", dict(nfilter=8, tfilter=8), 4),
    ("ttnet_imagenet_xsmall", dict(nfilter=4, tfilter=4), 4),
    ("ttnet_imagenet_small", dict(nfilter=4, tfilter=4), 2),   # 8 < 16
    ("ttnet_imagenet_small", dict(nfilter=8, tfilter=4), 3),   # 32 % 3
    ("ttnet_imagenet_vgg_stem", {}, 2),
    ("TT_FHE_SMALL", dict(nfilter=4, tfilter=4), 2),
], ids=["p32x2", "p64x4", "xsmall_p16x4", "misaligned", "indivisible",
        "vgg_stem", "tt_fhe"])
def test_local_config_matches_jax(name, kw, n):
    cfg = get_model(name, **kw).config
    jcfg = jget_model(name, **kw).config
    try:
        want = jtp.local_config(jcfg, n)
    except (ValueError, AttributeError) as e:
        with pytest.raises(ValueError) as got:
            tp.local_config(cfg, n)
        if isinstance(e, AttributeError):
            assert f"(AttributeError: {e})" in str(got.value)
        else:
            assert str(got.value) == str(e)
        return
    got = tp.local_config(cfg, n)
    assert (got.p, got.fcsize, got.nfilter, got.tfilter) == \
        (want.p, want.fcsize, want.nfilter, want.tfilter)
    assert [(b.in_planes, b.out_planes, b.convf_cfg().groupsici)
            for b in got.block_configs()] == \
        [(b.in_planes, b.out_planes, b.convf_cfg().groupsici)
         for b in want.block_configs()]


# ------------------------------------------------- slices and features

@pytest.fixture(scope="module")
def p32():
    """JAX's init of the p = 32 flagship in f64 and the port's model with
    the same values."""
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_small", np.float64, jit=True, **P32)
    x = images((4, 224, 224, 3), 41)
    feats = np.asarray(jax.jit(
        lambda p, s, a: jfeatures(p, s, jm.config, a)[0])(params, state, x))
    return jm, params, state, model, x, feats


def test_sliced_state_dicts_equal_jax_shards(p32):
    jm, params, state, model, _, _ = p32
    mesh = _jax_mesh(1, N_MODEL)
    jparams = jtp.shard_params_tp(params, mesh)
    jstate = jtp.shard_params_tp(state, mesh)
    lcfg = tp.local_config(model.cfg, N_MODEL)
    locals_ = []
    for m in range(N_MODEL):
        local = tp.shard_model(model, N_MODEL, m)
        locals_.append(local)
        want = state_dict_from_jax(_shard_of(jparams, mesh, m),
                                   _shard_of(jstate, mesh, m), lcfg)
        got = local.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v.to(got[k].dtype)), k
    # the inverse: the slices side by side are the whole model
    shapes = tp.full_shapes(model.cfg, locals_[0])
    axes = tp.split_axes(locals_[0], shapes)
    whole = model.state_dict()
    assert list(shapes) == list(whole)
    for k, v in whole.items():
        parts = [loc.state_dict()[k] for loc in locals_]
        got = parts[0] if axes[k] is None else torch.cat(parts, axes[k])
        assert torch.equal(got, v), k
    # one model rank: no split, no collective
    one = make_mesh(1, 1)
    assert one.model_group is None
    alone = tp.shard_model(model, 1, 0)
    got = tp.gather_tensors(alone.state_dict(), tp.split_axes(
        alone, tp.full_shapes(model.cfg, alone)), one)
    assert all(torch.equal(got[k], v) for k, v in whole.items())


def test_local_features_are_the_global_slice(p32):
    _, _, _, model, x, jfeats = p32
    xt = torch.from_numpy(x)
    with torch.no_grad():
        whole = ttnet_imagenet_features(model, xt)
        parts = [ttnet_imagenet_features(tp.shard_model(model, N_MODEL, m),
                                         xt) for m in range(N_MODEL)]
    width = whole.shape[1] // N_MODEL
    for m, part in enumerate(parts):
        assert part.shape == (4, width)
        sl = slice(m * width, (m + 1) * width)
        np.testing.assert_allclose(part.numpy(), whole[:, sl].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(part.numpy(), jfeats[:, sl], rtol=1e-9,
                                   atol=1e-9)


# --------------------------------------------------------------- LUTs

def test_lut_shards_equal_jax_and_the_local_compile():
    """xsmall at p = 32 (n <= 8 tables: the small variant's n = 16 heads
    take tens of seconds to enumerate on the CPU)."""
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_xsmall", np.float32, jit=True, **P32)
    jluts = jlut.compile_ttnet_lut(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, state),
                                   jm.config)
    mesh = _jax_mesh(1, N_MODEL)
    sharded = jtp.shard_luts_tp(jluts, mesh)
    whole = lut_eval.compile_ttnet_lut(model)
    for m in range(N_MODEL):
        local = tp.shard_model(model, N_MODEL, m)
        mine = tp.shard_luts(whole, local)
        own = lut_eval.compile_ttnet_lut(local)
        jshard = _shard_of(sharded, mesh, m)
        for lut, tl, ol, jl in zip(whole, mine, own, jshard):
            for i, h in tl.heads.items():
                assert h.cfg == ol.heads[i].cfg
                assert torch.equal(h.packed, ol.heads[i].packed)
                assert h.nonconstant == lut.heads[i].nonconstant
                np.testing.assert_array_equal(
                    h.packed.numpy(),
                    np.asarray(jl.heads[i].packed).reshape(h.packed.shape))
            for (ids, words), (oids, owords) in zip(tl.merged, ol.merged):
                assert ids == oids
                if words is not None:
                    assert words.is_contiguous()
                    assert torch.equal(words, owords)
            c = tl.convf
            assert c.nonconstant == lut.convf.nonconstant
            if not c.cfg.last:
                assert torch.equal(c.packed, ol.convf.packed)
                np.testing.assert_array_equal(
                    c.packed.numpy(),
                    np.asarray(jl.convf.packed).reshape(c.packed.shape))
                continue
            np.testing.assert_allclose(
                c.packed.numpy(), ol.convf.packed.numpy(), rtol=0,
                atol=1e-6)
            np.testing.assert_allclose(
                c.packed.numpy(),
                K.pack_float_table(np.array(jl.convf.table).T,
                                   c.cfg.groupsici).numpy(),
                rtol=0, atol=1e-6)
        assert mine[-1].convf.cfg.last


# ------------------------------------------ the row-parallel all-reduce

class _FakeGroup:
    """A two-member model group whose peer holds the same partial: the
    sum doubles it."""

    calls = 0

    @staticmethod
    def all_reduce(t, group=None):
        _FakeGroup.calls += 1
        t.mul_(2)

    @staticmethod
    def get_world_size(group=None):
        return 2


def test_sum_over_model_backward_is_the_identity(monkeypatch):
    monkeypatch.setattr(tp, "_dist", lambda group: _FakeGroup)
    partial = torch.arange(6.0, dtype=torch.float64).reshape(2, 3) \
        .requires_grad_()
    upstream = torch.tensor([[1.0, -2.0, 3.0], [0.5, 0.25, -1.0]],
                            dtype=torch.float64)
    y = tp.sum_over_model(partial, "model")
    assert torch.equal(y, 2 * partial.detach())
    y.backward(upstream)
    # the gradient of the partial product is the upstream gradient itself:
    # a backward that summed too would double it
    assert torch.equal(partial.grad, upstream)
    assert _FakeGroup.calls == 1
    # a bf16 partial sums in f32 and comes back in bf16
    b = tp.sum_over_model(torch.ones(3, dtype=torch.bfloat16), "model")
    assert b.dtype == torch.bfloat16 and torch.equal(b.float(),
                                                     torch.full((3,), 2.0))


# ------------------------------------------------------------- the mesh

@pytest.mark.parametrize("data,model,world", [
    (-1, 2, 2), (1, 2, 2), (-1, 2, 4), (2, 2, 4), (-1, 4, 8), (2, 4, 8),
    (-1, 1, 4), (-1, 2, 3), (3, 2, 4), (1, 2, 4)],
    ids=["1x2", "1x2_explicit", "2x2", "2x2_explicit", "2x4", "2x4_explicit",
         "4x1", "indivisible", "too_large", "submesh"])
def test_mesh_layout_and_messages_match_jax(data, model, world):
    devices = jax.devices()[:world]
    try:
        want = jmesh.make_mesh(data, model, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(data, model, world)
        assert str(got.value) == str(e)
        return
    if want.devices.size < world:
        # JAX's submesh of its first devices: refused over ranks
        with pytest.raises(ValueError, match="submesh"):
            make_mesh(data, model, world)
        return
    for rank, dev in enumerate(devices):
        mesh = make_mesh(data, model, world, rank)
        assert mesh == dict(want.shape)
        d, m = map(int, np.argwhere(want.devices == dev)[0])
        assert (mesh.data_index, mesh.model_index) == (d, m)
        assert rank in mesh.data_ranks(m) and rank in mesh.model_ranks(d)
        assert [devices[r] for r in mesh.data_ranks(m)] == \
            list(want.devices[:, m])
        assert [devices[r] for r in mesh.model_ranks(d)] == \
            list(want.devices[d])
        # no process group here: no group is created (a mesh over
        # several ranks creates them, tests/test_torch_tp_cli.py)
        assert mesh.data_group is None and mesh.model_group is None
