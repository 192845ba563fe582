"""Serving over several devices in one process, below the CLI: the local
mesh (``parallel/mesh.py::make_local_mesh``), the placements and the
exchange (``parallel/local.py``) and the replicas' forward
(``runtime/server.py::make_forward``), on the CPU, where the mesh's
devices are CPU devices:

* the local mesh's checks and texts against JAX's ``make_mesh`` over as
  many of its 8 CPU devices, its submesh of the first devices allowed;
* ``LocalGroup``: f64 sums in member order, the same bits on every
  member; a member that calls it out of turn meets the barrier's timeout;
* the split of a padded batch and the gather of its probabilities;
  ``replicate`` of a model and its tables;
* the sharded forward's f64 probabilities equal the one-device forward's
  of each data slice exactly at 2x1, 1x2 ``--sp``, 2x4 ``--sp`` (JAX's
  own test shape) and 2x1 with ``--lut`` and ``--gates dnf``, and the
  whole batch's within 1e-15 (the classifier's GEMM rounds by its
  rows); a model of each config type at 1x2 ``--sp`` through
  ``sp_forward`` within 1e-12 of its one-device forward;
* a stochastic model's flips: one data index keys as one device, two key
  their own, and two forwards from one seed agree batch for batch;
* the kernels' launch counters count every launch made from several
  threads; the capability check names a card that is not sm_90.
"""

import functools
import threading
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401
from test_torch_sp_families import CASES, batch, model_of

from scale_imagenet_tpu.parallel import mesh as jmesh
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.compile.lut_eval import MultiHeadLUT
from scale_imagenet_tpu_torch.kernels import build
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
from scale_imagenet_tpu_torch.kernels import lut_gather as K
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    TTnetImageNetConfig
from scale_imagenet_tpu_torch.parallel import LocalGroup, gather_probs, \
    make_local_mesh, replicate, split_batch
from scale_imagenet_tpu_torch.parallel.sp import row_bounds
from scale_imagenet_tpu_torch.runtime import server

pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")
SMALL = dict(nfilter=4, tfilter=4, layers=0)


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("data,model,n", [
    (-1, 4, 8), (2, 4, 8), (1, 2, 8), (3, 2, 8), (-1, 1, 1), (1, 1, 8),
    (-1, 3, 8), (3, 4, 8), (2, 1, 1)],
    ids=["auto", "full", "submesh", "submesh_odd", "one", "one_of_eight",
         "indivisible", "too_large", "too_large_one"])
def test_local_mesh_is_jax_make_mesh(data, model, n):
    """The axis sizes, the devices in (data, model) order with the model
    axis innermost, or JAX's text, over ``n`` devices."""
    devices = [torch.device("cpu")] * n
    jdevs = jax.devices()[:n]
    try:
        want = jmesh.make_mesh(data, model, devices=jdevs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_local_mesh(data, model, devices)
        assert str(got.value) == str(e)
        return
    got = make_local_mesh(data, model, devices)
    assert dict(got) == dict(want.shape)
    # the device at (d, m) is the list's d*M + m-th, as JAX lays them out
    ids = [[jdevs.index(dv) for dv in row] for row in want.devices]
    assert ids == [[d * got["model"] + m for m in range(got["model"])]
                   for d in range(got["data"])]
    assert len(got.devices) == got["data"] * got["model"]


def test_local_mesh_names_the_current_card():
    """A card without its index is the current one; the CPU stays."""
    with mock.patch.object(torch.cuda, "current_device", lambda: 3):
        mesh = make_local_mesh(2, 1, ["cuda", "cuda:1"])
    assert mesh.devices == [torch.device("cuda", 3),
                            torch.device("cuda", 1)]
    assert make_local_mesh(1, 1, ["cpu"]).device(0) == CPU


# ------------------------------------------------------------ the group

def _members(group, fn, n):
    """``fn(i, member)`` in ``n`` threads: results, or the exceptions."""
    out = [None] * n

    def go(i):
        try:
            out[i] = fn(i, group.member(i))
        except BaseException as e:        # noqa: BLE001: the test reads it
            out[i] = e
    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_local_group_sums_in_member_order():
    """Three members' f64 terms whose sum depends on the order: every
    member gets ``(t0 + t1) + t2`` bit for bit, each call in turn."""
    terms = [torch.tensor([1e16, 1.0, 3.0], dtype=torch.float64),
             torch.tensor([1.0, 1e16, 2.0 ** -30], dtype=torch.float64),
             torch.tensor([-1e16, -1e16, 1.0], dtype=torch.float64)]
    want = (terms[0] + terms[1]) + terms[2]
    assert not torch.equal(want, terms[0] + (terms[1] + terms[2]))
    group = LocalGroup([CPU] * 3)

    def member(i, me):
        outs = []
        for k in range(3):                 # three rounds, one buffer each
            t = terms[i].clone() * (k + 1)
            me.all_reduce(t)
            outs.append(t)
        return outs
    got = _members(group, member, 3)
    for outs in got:
        assert not isinstance(outs, BaseException), outs
        for k, t in enumerate(outs):
            ref = (terms[0] * (k + 1) + terms[1] * (k + 1)) \
                + terms[2] * (k + 1)
            assert torch.equal(t, ref)
    assert torch.equal(got[0][0], want)


def test_local_group_member_out_of_turn_times_out():
    """Member 0 calls alone: the barrier breaks after its timeout (no
    hang), and the group is mended for the next call."""
    group = LocalGroup([CPU, CPU], timeout=0.2)
    with pytest.raises(threading.BrokenBarrierError):
        group.member(0).all_reduce(torch.ones(3))
    group.reset()
    got = _members(group, lambda i, me: me.all_reduce(
        t := torch.full((2,), float(i + 1))) or t, 2)
    assert all(torch.equal(t, torch.full((2,), 3.0)) for t in got)


# ------------------------------------------------- split, gather, copies

def test_split_and_gather():
    xs = np.random.default_rng(0).standard_normal(
        (8, 224, 6, 3)).astype(np.float32)
    mesh = make_local_mesh(2, 4, [CPU] * 8)
    pieces = split_batch(xs, mesh, spatial=True)
    assert sorted(pieces) == [(d, m) for d in range(2) for m in range(4)]
    for (d, m), piece in pieces.items():
        lo, hi = row_bounds(224, 4, m)
        assert piece.is_contiguous()
        assert np.array_equal(piece.numpy(), xs[4 * d:4 * d + 4, lo:hi])
    dp = split_batch(xs, mesh)
    assert sorted(dp) == [(0, 0), (1, 0)]
    assert np.array_equal(dp[1, 0].numpy(), xs[4:])
    probs = {(d, 0): torch.full((4, 3), float(d)) for d in range(2)}
    got = gather_probs(probs, mesh)
    assert got.shape == (8, 3) and (got[:4] == 0).all() \
        and (got[4:] == 1).all()


def test_replicate_copies_every_tensor():
    """A model and its tables: equal values in new memory, the merged
    heads' words derived again (each head a view of them)."""
    from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut

    model = get_model("ttnet_imagenet_xsmall", **SMALL).init(seed=0,
                                                            device="cpu")
    luts = compile_ttnet_lut(model)
    state = (luts, model)
    copied = replicate(state, CPU)
    assert isinstance(copied, tuple) and copied[1] is not model
    for a, b in zip(model.state_dict().values(),
                    copied[1].state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    for old, new in zip(luts, copied[0]):
        assert isinstance(new, MultiHeadLUT) and new is not old
        assert new.cfg is old.cfg
        for i, head in old.heads.items():
            assert torch.equal(head.packed, new.heads[i].packed)
            assert head.packed.data_ptr() != new.heads[i].packed.data_ptr()
        for (ids, words), (ids2, words2) in zip(old.merged, new.merged):
            assert ids == ids2
            if words is not None:
                assert torch.equal(words, words2)
                base = words2.data_ptr()
                assert new.heads[ids2[0]].packed.data_ptr() == base
    assert replicate({"k": 3, "cfg": model.cfg}, CPU) == {"k": 3,
                                                          "cfg": model.cfg}


# -------------------------------------------- the sharded forward, exact

def _perturbed(name: str, seed: int = 1, **kw):
    """A seeded f64 model, its BN statistics perturbed."""
    md = get_model(name, **kw)
    model = md.init(seed=seed, device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.running_mean.shape
                m.running_mean.add_(0.05 * torch.randn(
                    n, generator=gen, dtype=torch.float64))
                m.running_var.mul_(torch.exp(0.05 * torch.randn(
                    n, generator=gen, dtype=torch.float64)))
    return md, model


def _f64_probs(apply, x):
    """The server's probabilities without its f32 cast."""
    return torch.softmax(apply(x), dim=-1)


def _forward(apply, model, stochastic, mesh, spatial, seed=0):
    cfg = types.SimpleNamespace(seed=seed)
    return server.make_forward(cli._replicas(cfg, mesh, apply, model,
                                             stochastic), mesh, spatial)


def _both(apply, model, xs, data, m_axis, spatial, stochastic=False,
          calls=1):
    """``calls`` batches through the one-device forward, on each data
    slice of the batch (the rows a replica is given), and through the
    (data, model) mesh's, f64 probabilities.  The slices, not the whole
    batch: the classifier's f64 GEMM rounds by the rows it is given
    (``test_sharded_forward_equals_one_device`` holds the whole batch to
    1e-15)."""
    b = xs.shape[0] // data
    with mock.patch.object(server, "_probs", _f64_probs):
        one = _forward(apply, model, stochastic,
                       make_local_mesh(1, 1, [CPU]), False)
        want = [np.concatenate([one(xs[d * b:(d + 1) * b])
                                for d in range(data)])
                for _ in range(calls)]
        mesh = make_local_mesh(data, m_axis, [CPU] * (data * m_axis))
        fwd = _forward(apply, model, stochastic, mesh, spatial)
        try:
            got = [fwd(xs) for _ in range(calls)]
        finally:
            fwd.close()
    return want, got


def _images(b, side, seed):
    return np.random.default_rng(seed).uniform(
        size=(b, side, side, 3)).astype(np.float64)


@pytest.fixture(scope="module")
def flagship():
    """``ttnet_imagenet_small`` at nfilter = tfilter = 4, ``--layers 0``
    (JAX's serve mesh test), f64."""
    return _perturbed("ttnet_imagenet_small", **SMALL)[1]


@pytest.mark.parametrize("data,m_axis,spatial,b", [
    (2, 1, False, 4), (1, 2, True, 2), (2, 4, True, 4)],
    ids=["2x1", "1x2_sp", "2x4_sp"])
def test_sharded_forward_equals_one_device(flagship, data, m_axis, spatial,
                                           b):
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply
    xs = _images(b, 224, 5)
    apply = functools.partial(ttnet_imagenet_apply, flagship)
    (want,), (got,) = _both(apply, flagship, xs, data, m_axis, spatial)
    assert want.dtype == np.float64 and want.shape == (b, 1000)
    assert np.array_equal(got, want)
    (whole,), _ = _both(apply, flagship, xs, 1, 1, False)
    assert np.allclose(got, whole, rtol=0, atol=1e-15)


@pytest.fixture(scope="module")
def xsmall():
    """The smallest flagship variant in f64, its tables and covers."""
    from scale_imagenet_tpu_torch.compile.gate_net import \
        compile_ttnet_gates
    from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut

    model = _perturbed("ttnet_imagenet_xsmall", **SMALL)[1]
    return model, compile_ttnet_lut(model), compile_ttnet_gates(model)


@pytest.mark.parametrize("kind", ["lut", "gates_dnf"])
def test_compiled_forward_at_2x1_equals_one_device(xsmall, kind):
    """Every replica walks its slice with its copy of the tables or the
    covers (``--mesh_data 2``), as ``shard_map_dp_apply`` does."""
    from scale_imagenet_tpu_torch.compile.gate_device import \
        build_device_gates, gate_ttnet_apply_device
    from scale_imagenet_tpu_torch.compile.lut_eval import lut_ttnet_apply

    model, luts, gnets = xsmall
    if kind == "lut":
        apply = functools.partial(lut_ttnet_apply, luts, model)
    else:
        apply = functools.partial(gate_ttnet_apply_device,
                                  build_device_gates(gnets, "dnf"), model)
    xs = _images(4, 224, 9)
    (want,), (got,) = _both(apply, model, xs, 2, 1, False)
    assert np.array_equal(got, want)
    # the conv forward's answer, which the tables hold
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply
    (conv,), _ = _both(functools.partial(ttnet_imagenet_apply, model),
                       model, xs, 1, 1, False)
    assert (conv.argmax(1) == got.argmax(1)).all()


# a registry name of each config type but the flagship family's, from
# ``tests/test_torch_sp_families.py``'s cases
ONE_A_TYPE = ("TT_vf_19lv3_imgnet_xsmall_VGG", "TT_FHE_small",
              "TT_FHE_XSMALL_vAlexnet", "TT_vf_19lv2_imgnet", "TT_general",
              "TT_general_correctBN", "mobilenet_v2_tt", "mobilenet_v1_tt",
              "model_general", "cifar10lownoise", "tt_certif",
              "resnet18_cifar")


@pytest.mark.parametrize("name", ONE_A_TYPE)
def test_every_family_at_1x2_sp(name):
    """Each config type's ``sp_forward`` on two replicas joined by a
    ``LocalGroup``: within 1e-12 of its one-device forward (as
    ``tests/test_torch_sp_families.py`` holds the emulated ranks), a
    stochastic one flipping the one-device forward's bits from one
    seed."""
    md, model = model_of(name)
    apply = functools.partial(cli._family(md.config).conv, model)
    xs = batch(name, 3).numpy()
    (want,), (got,) = _both(apply, model, xs, 1, 2, True, md.stochastic)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=0, atol=1e-12)


def test_stochastic_keys_per_data_index():
    """``TT_FHE_small``: one data index (1x2 ``--sp``) flips what one
    device flips, batch after batch; at 2x1 each data index keys its own
    (the same image in both slices scores apart), and two forwards from
    one seed agree batch for batch."""
    md, model = model_of("TT_FHE_small")
    apply = functools.partial(cli._family(md.config).conv, model)
    img = batch("TT_FHE_small", 4, b=1).numpy()
    xs = np.concatenate([img, img])
    want, got = _both(apply, model, xs, 1, 2, True, True, calls=2)
    assert all(np.allclose(g, w, rtol=0, atol=1e-12)
               for g, w in zip(got, want))
    assert not np.array_equal(want[0], want[1])    # fresh flips a batch
    _, dp = _both(apply, model, xs, 2, 1, False, True, calls=2)
    _, again = _both(apply, model, xs, 2, 1, False, True, calls=2)
    assert all(np.array_equal(a, b) for a, b in zip(dp, again))
    assert not np.array_equal(dp[0][0], dp[0][1])
    assert not np.array_equal(dp[0], dp[1])


def test_replica_fault_reaches_the_caller_and_the_group_mends():
    """A replica that raises fails the batch with its own error (its peer
    meets a broken barrier at once, not the timeout); the next batch
    runs."""
    import time

    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply

    model = _perturbed("ttnet_imagenet_xsmall", **SMALL)[1]
    real, failed = server._probs, []

    def probs(apply, x):
        if threading.current_thread().name == "replica-d0-m1" \
                and not failed:
            failed.append(1)
            raise RuntimeError("replica fault")
        return real(apply, x)
    mesh = make_local_mesh(1, 2, [CPU, CPU])
    xs = _images(2, 224, 1)
    with mock.patch.object(server, "_probs", probs):
        fwd = _forward(functools.partial(ttnet_imagenet_apply, model),
                       model, False, mesh, True)
        try:
            t = time.perf_counter()
            with pytest.raises(RuntimeError, match="replica fault"):
                fwd(xs)
            assert time.perf_counter() - t < 30
            assert fwd(xs).shape == (2, 1000)
        finally:
            fwd.close()


# ------------------------------------------------------- kernel counters

def test_launch_counters_count_every_thread():
    """Eight threads count 2,000 launches each on every counter."""
    K.reset_launches()
    FB.reset_launches()
    GC.reset_launches()

    def launch():
        for _ in range(2000):
            K._count(K.lut_window_bits)
            K._count(K.lut_window_float)
            FB._count()
            GC._count()
    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert K.lut_window_bits.launches == K.lut_window_float.launches \
            == FB.fused_pointwise_block.launches == GC.gate_cubes.launches \
            == 16000
    finally:
        K.reset_launches()
        FB.reset_launches()
        GC.reset_launches()


def test_capability_checked_on_every_card():
    """Each card a kernel launches on is checked once, and one that is not
    sm_90 is named."""
    caps = {0: (9, 0), 1: (8, 0)}
    seen = []

    def cap(index):
        seen.append(index)
        return caps[index]
    with mock.patch.object(torch.cuda, "get_device_capability", cap), \
            mock.patch.dict(build._checked, clear=True):
        build.check_device(torch.device("cuda", 0))
        build.check_device(torch.device("cuda", 0))
        with pytest.raises(RuntimeError, match="cuda:1 is sm_80"):
            build.check_device(torch.device("cuda", 1))
    assert seen == [0, 1]


def test_families_of_the_cases_cover_the_registry():
    """The 1x2 cases take every config type but the flagship family's
    (which the exact tests above take)."""
    assert set(ONE_A_TYPE) <= set(CASES)
    kinds = [type(model_of(n)[0].config) for n in ONE_A_TYPE]
    assert len(kinds) == len(set(kinds))
    assert set(kinds) | {TTnetImageNetConfig} == set(cli._FAMILIES)
