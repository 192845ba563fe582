"""The data-parallel runtime (``scale_imagenet_tpu_torch/parallel/``)
against the JAX package on the CPU.

* The mesh over ranks and the batch rules, with the JAX package's
  messages (``parallel/mesh.py``), and the port's refusal of a submesh.
* The shard reader's lockstep across ranks: every rank's batches and
  counts equal JAX's ``ShardDataset.iter_batches`` with and without
  ``drop_last`` (training truncates every rank to the fewest full
  batches of any rank).
* One two-process gloo launch (``tests/_torch_dp_worker.py``) runs, in f64
  from one JAX init with augmentation off, one data-parallel step of each
  of three kinds: the plain step, a ``--grad_accum 2`` step and a
  deterministic robust step (``--abstract_eps`` with ``--bias_decay`` on
  ``cifar10lownoise``).  Each is held against JAX's ``make_train_step`` or
  ``make_robust_train_step`` on a 2x1 mesh of the conftest's virtual CPU
  devices (its ``shard_map`` branch: each device its half of the batch,
  gradients, BN running statistics and metrics ``pmean``'d): parameters,
  BN statistics and metrics to 1e-9, and the two ranks' states bit-equal.
  Rank 1 starts from rank 0's weights through the broadcast alone.
  Under this JAX (0.9), ``shard_map`` hands the gradient of a replicated
  parameter already summed over the shards (the transpose of its
  implicit broadcast), so the JAX step's ``pmean`` of it returns the SUM:
  its update takes ``world`` times the mean gradient
  (``test_jax_shard_map_sums_replicated_gradients``), against its own
  docstring and the reference's DDP (a gradient term that no shard's data
  enters, such as a decay-in-gradient STE's, is not summed, so no scale
  undoes it).  The port takes the mean; the JAX steps are built here with
  ``shard_map(check_vma=False)``, under which every value is per-shard
  and the steps' ``pmean``s average, as their code says.
* In the same launch, a stochastic model (``TT_FHE_small``) keyed as a
  rank's step of ``main --mode train`` draws different coin flips on the
  two ranks.
"""

import functools
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_port import _FAST_COMPILE, few_threads, images, jax_and_port, \
    launch_ranks, free_port  # noqa: F401
from test_torch_cifar_zoo import assert_trees_match, zoo_pair

from scale_imagenet_tpu.data import shards as jshards
from scale_imagenet_tpu.parallel import mesh as jmesh
from scale_imagenet_tpu.train import TrainState as JTrainState
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu.train import make_train_step as jmake_train_step
from scale_imagenet_tpu.train.steps import \
    make_robust_train_step as jmake_robust_train_step
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.data import ArrayDataset, ShardDataset, \
    shard_loader, write_shards
from scale_imagenet_tpu_torch.parallel import is_coordinator, \
    local_batch_size, make_mesh, rank_key, rank_seed
from scale_imagenet_tpu_torch.parallel import multihost
from scale_imagenet_tpu_torch.parallel.mesh import SUBMESH
from scale_imagenet_tpu_torch.ops.binarize import NoiseKey

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

OPT = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
XSMALL = dict(nfilter=4, tfilter=4, layers=0, image_size=64)
ROBUST = dict(eps=0.0, coeff=0.0, abstract_eps=0.01, abstract_coeff=0.01,
              bias_coeff=0.05, bias_thresh=0.5)
CASES = ("plain", "accum2", "robust")


# ------------------------------------------------------------- the mesh

def _jax_mesh(world):
    return jmesh.make_mesh(-1, 1, devices=jax.devices()[:world])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_over_ranks(world):
    assert make_mesh(-1, 1, world) == {"data": world, "model": 1}
    assert make_mesh(world, 1, world) == dict(_jax_mesh(world).shape)
    with pytest.raises(ValueError) as ours:
        make_mesh(world + 1, 1, world)
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(world + 1, 1, devices=jax.devices()[:world])
    assert str(ours.value) == str(ref.value)
    for batch in (4 * world, 4 * world + 1):
        mesh = make_mesh(-1, 1, world)
        if batch % world:
            with pytest.raises(ValueError) as ours:
                local_batch_size(batch, mesh)
            with pytest.raises(ValueError) as ref:
                jmesh.local_batch_size(batch, _jax_mesh(world))
            assert str(ours.value) == str(ref.value)
        else:
            assert local_batch_size(batch, mesh) == \
                jmesh.local_batch_size(batch, _jax_mesh(world)) == \
                batch // world


def test_submesh_and_model_axis_are_refused():
    with pytest.raises(ValueError) as err:
        make_mesh(1, 1, 2)
    assert str(err.value) == SUBMESH.format(data=1, world=2)
    # a model axis is a mesh now (``tests/test_torch_tp.py``); one that
    # the world does not fill is a submesh, one it cannot hold JAX's error
    assert make_mesh(-1, 2, 2) == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="submesh of its first 2 devices"):
        make_mesh(1, 2, 4)
    with pytest.raises(ValueError, match="3 devices not divisible by "
                                         "model=2"):
        make_mesh(-1, 2, 3)
    with pytest.raises(ValueError, match="-1 .every rank. or a count"):
        make_mesh(0, 1, 2)


def test_rank_seeds_and_keys():
    """One process draws what it always drew (and coordinates); ranks draw
    their own."""
    assert is_coordinator()
    assert rank_seed(7, 0, 1) == 7
    seeds = {rank_seed(7, r, 3) for r in range(3)}
    assert len(seeds) == 3 and all(0 <= s < 2 ** 63 for s in seeds)
    root = NoiseKey(5)
    assert rank_key(root, 0, 1) is root and rank_key(None, 1, 2) is None
    assert rank_key(root, 1, 2).seed == root.child("rank1").seed


def test_backend_rule(monkeypatch):
    """NCCL when every rank has a card of its own, gloo when ranks share
    one or one runs on the CPU; a card is named by its host and its
    ``CUDA_VISIBLE_DEVICES`` entry where that is set."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert multihost.choose_backend(["", ""]) == "gloo"
    assert multihost.choose_backend(["a/0", ""]) == "gloo"
    assert multihost.choose_backend(["a/0", "a/0"]) == "gloo"
    assert multihost.choose_backend(["a/0", "a/1"]) == "nccl"
    assert multihost.choose_backend(["a/0", "b/0"]) == "nccl"
    assert multihost.card_id("a", 1) == "a/1"
    assert [multihost.local_rank(["a", "b", "a", "b"], r)
            for r in range(4)] == [0, 0, 1, 1]
    # ranks that each see one card of several: their entries differ
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert multihost.card_id("a", 0) == "a/3"


@pytest.mark.parametrize("hosts,cards,backend,devices", [
    (["a", "b"], 1, "nccl", [0, 0]),
    (["a", "a"], 1, "gloo", [0, 0]),
    (["a", "a"], 2, "nccl", [0, 1]),
    (["a", "b", "a", "b"], 2, "nccl", [0, 0, 1, 1]),
], ids=["two_hosts_one_card", "one_card_shared", "one_host_two_cards",
        "hosts_interleaved"])
def test_flag_launch_takes_cards_and_backend_from_the_hosts(
        monkeypatch, hosts, cards, backend, devices):
    """Ranks launched by ``--num_processes/--process_id
    /--coordinator_address`` (no torchrun, so no ``LOCAL_RANK``), each a
    thread here with its own hostname: through the rendezvous's store,
    each takes ``cuda:i`` for its index i among its host's ranks, and all
    agree on the backend (two hosts of one card a rank: NCCL)."""
    import socket
    import threading

    import torch.distributed as dist

    for var in ("LOCAL_RANK", "RANK", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    me = threading.local()
    made, stores = {}, []
    monkeypatch.setattr(socket, "gethostname", lambda: me.host)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def init_process_group(backend, store, world_size, rank):
        made[rank] = backend
        stores.append(store)     # a group holds the store: rank 0 serves it

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(multihost, "_joined", {})
    address = f"localhost:{free_port()}"
    got = {}

    def run(rank):
        me.host = hosts[rank]
        got[rank] = multihost.initialize(address, len(hosts), rank)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert made == dict.fromkeys(range(len(hosts)), backend)
    assert [got[r][2] for r in range(len(hosts))] == [
        torch.device("cuda", d) for d in devices]


# ------------------------------------------------- the shard lockstep

@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_shard_lockstep_matches_jax(tmp_path, world, drop_last):
    """Uneven shards (37 images in shards of 10): every rank's batches
    and count equal JAX's; with ``drop_last`` every rank stops at the
    fewest full batches of any rank."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (37, 4, 5, 3), dtype=np.uint8)
    labels = rng.integers(0, 9, 37).astype(np.int32)
    write_shards(ArrayDataset(imgs, labels), str(tmp_path), shard_size=10)
    ours, ref = ShardDataset(str(tmp_path)), jshards.ShardDataset(
        str(tmp_path))
    want_n = ref.rank_batches(4, drop_last, world)
    assert ours.rank_batches(4, world, drop_last=drop_last) == want_n
    for rank in range(world):
        for shuffle in (None, 3):
            got = list(ours.iter_batches(4, rank=rank, world=world,
                                         drop_last=drop_last,
                                         shuffle=shuffle))
            want = list(ref.iter_batches(4, drop_last=drop_last, rank=rank,
                                         world=world, shuffle=shuffle))
            assert len(got) == len(want) == want_n
            for (a, la), (b, lb) in zip(got, want):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(la, lb)
        loader = shard_loader(str(tmp_path), 4, drop_last=drop_last,
                              shuffle=True, seed=1, rank=rank, world=world)
        jloader = jshards.shard_loader(str(tmp_path), 4, drop_last=drop_last,
                                       rank=rank, world=world, shuffle=True,
                                       seed=1)
        loader.set_epoch(2)
        jloader.set_epoch(2)
        assert len(loader) == len(jloader) == want_n
        for (a, la), (b, lb) in zip(loader, jloader):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)


# ------------------------------------- the data-parallel steps vs JAX

@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_jax_shard_map_sums_replicated_gradients():
    """The JAX fault the comparison corrects for (module docstring)."""
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ("data", "model"))

    def grad_pmean(w, x):
        g = jax.grad(lambda w: jnp.sum(w * x))(w)
        return jax.lax.pmean(g, "data")

    f = jax.jit(jax.shard_map(grad_pmean, mesh=mesh,
                              in_specs=(P(), P("data")), out_specs=P()))
    # the mean of the shards' gradients is (1 + 2) / 2
    assert float(f(jnp.ones(()), jnp.array([1.0, 2.0]))) == 3.0


def _jax_dp_step(step_fn, params, state, x, y):
    """One step of a JAX step factory's ``shard_map`` branch over a 2x1
    mesh of the virtual CPU devices, built without the varying-axes
    check (module docstring): ``(params, state, metrics)``."""
    tx, _ = jmake_optimizer(**OPT)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ("data", "model"))
    with mock.patch.object(jax, "shard_map", functools.partial(
            jax.shard_map, check_vma=False)):
        step = step_fn(tx, mesh)
    p = jax.tree.map(jnp.array, params)
    ts = JTrainState(p, jax.tree.map(jnp.array, state), tx.init(p),
                     jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(0)   # folded per shard; drawn by nothing here
    compiled = step.lower(ts, x, y, key).compile(_FAST_COMPILE)
    ts, m = compiled(ts, x, y, key)
    return (jax.tree.map(np.asarray, ts.params),
            jax.tree.map(np.asarray, ts.model_state),
            {k: float(v) for k, v in m.items()})


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, x64_module):
    """The JAX steps, and the ports' from one two-process launch (started
    first: the two sides run at once)."""
    work = tmp_path_factory.mktemp("dp")
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_xsmall", np.float64, jit=True, **XSMALL)
    rng = np.random.default_rng(21)
    x = images((8, 64, 64, 3), 22)
    y = rng.integers(0, 1000, 8).astype(np.int32)
    rjm, rparams, rstate, rmd, rmodel = zoo_pair("cifar10lownoise", {},
                                                 seed=23)
    # four images a rank: at two, a 1-D BN's batch statistics put its
    # outputs at +-1 / sqrt(1 + eps / var), a hair inside the STE window's
    # edge, where the two frameworks' roundings choose the mask apart
    rx = images((8, 32, 32, 3), 24)
    ry = rng.integers(0, rmd.config.num_classes, 8).astype(np.int32)
    plain = dict(name="ttnet_imagenet_xsmall", kw=XSMALL, robust=False,
                 state=model.state_dict(), x=torch.from_numpy(x),
                 y=torch.from_numpy(y))
    cases = [{**plain, "id": "plain", "step": {}},
             {**plain, "id": "accum2", "step": {"accum": 2}},
             dict(id="robust", name="cifar10lownoise", kw={}, robust=True,
                  state=rmodel.state_dict(), x=torch.from_numpy(rx),
                  y=torch.from_numpy(ry), step=ROBUST)]
    stochastic = dict(name="TT_FHE_small", kw=dict(nfilter=4, tfilter=4),
                      seed=25, x=torch.rand(4, 32, 32, 3,
                                            generator=torch.Generator()
                                            .manual_seed(26)))
    torch.save({"cases": cases, "opt": OPT, "stochastic": stochastic},
               work / "job.pt")
    address = f"localhost:{free_port()}"
    outs = {}
    ranks = threading.Thread(target=lambda: outs.setdefault(
        "logs", launch_ranks(lambda r: [
            "tests/_torch_dp_worker.py", str(r), "2", address,
            str(work / "job.pt"), str(work)])))
    ranks.start()
    want = {
        "plain": _jax_dp_step(lambda tx, mesh: jmake_train_step(
            jm, tx, mesh), params, state, x, y),
        "accum2": _jax_dp_step(lambda tx, mesh: jmake_train_step(
            jm, tx, mesh, accum=2), params, state, x, y),
        "robust": _jax_dp_step(lambda tx, mesh: jmake_robust_train_step(
            rjm, tx, mesh=mesh, **ROBUST), rparams, rstate, rx, ry)}
    ranks.join()
    assert "logs" in outs, "the ranks did not finish"
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return want, got, {"plain": md, "accum2": md, "robust": rmd}


@pytest.mark.parametrize("case", CASES)
def test_dp_step_matches_jax_shard_map(dp_run, case):
    want, got, mds = dp_run
    wparams, wstate, wmetrics = want[case]
    r0, r1 = got[0][case], got[1][case]
    # the ranks take the same update
    assert r0["state"].keys() == r1["state"].keys()
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(wmetrics)
    for k, v in wmetrics.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    model = mds[case].init(device="cpu", dtype=torch.float64)
    model.load_state_dict(r0["state"], strict=True)
    params, state = jax_trees(model)
    assert_trees_match(params, wparams, rtol=1e-9, atol=1e-9)
    assert_trees_match(state, wstate, rtol=1e-9, atol=1e-9)


def test_stochastic_ranks_draw_their_own_flips(dp_run):
    _, got, _ = dp_run
    f0, f1 = got[0]["flips"], got[1]["flips"]
    assert len(f0) == len(f1) > 0
    assert all(a.shape == b.shape for a, b in zip(f0, f1))
    assert all(not torch.equal(a, b) for a, b in zip(f0, f1))
