"""The data-parallel collectives (counterpart of the data-parallel half of
``scale_imagenet_tpu/parallel/sharding.py`` and of the ``pmean``s that the
JAX package's ``shard_map`` train steps state, ``train/steps.py:308-325,
437-470``).

Each rank runs the unmodified forward on its slice of the batch (the JAX
package's ``shard_map_dp_apply``: the compiled LUT and gate forwards need
nothing more).  What joins the ranks is explicit:

* ``all_reduce_mean_``: after the gradient phase of a train step, one
  ``all_reduce`` of the gradients, the new BN running statistics and the
  step's metrics, flattened into one buffer a dtype, then divided by the
  group's size: the mean over the mesh's data axis (the whole world
  without a model axis), as JAX's ``pmean(.., "data")`` after its
  microbatch scan.  A channel-sharded gradient averaged over the world
  would mix two channel slices, so the model axis never takes part.  ``DistributedDataParallel`` is not used: it reduces inside every
  backward (every microbatch of ``--grad_accum``), its
  ``broadcast_buffers`` replaces the ranks' BN statistics with rank 0's
  instead of averaging them, and it hooks ``forward``, which the ``--amp``
  step bypasses through ``torch.func.functional_call``;
* ``all_reduce_sums``: the global sums of the eval metrics (loss, top-1,
  top-5, ``cert``, ``adv`` and the image counts) over the data axis, so
  that rank 0 prints the whole set's metrics (the model axis's ranks
  score the same images);
* ``broadcast_module_``: rank 0's parameters and buffers to every rank,
  after the model is built or loaded;
* ``rank_seed``/``rank_key``: a data index's own augmentation and coin
  flips, as JAX folds the data index into the step's key
  (``steps.py:315,441``, ``parallel/tp.py:339-340``): the ranks of one
  model group draw the same.

Every function is a no-op without a process group, or over a group of
one rank.  With gloo a
collective on CUDA tensors goes through the host, so each step waits for
the card there; with NCCL it is queued on the card's stream.
"""

from __future__ import annotations

import torch

from ..ops.binarize import NoiseKey


def _dist(group=None):
    """``torch.distributed`` when ``group`` (None: every rank) holds more
    than one rank, else None (a group of one rank, or no process group)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    return dist if dist.get_world_size(group) > 1 else None


def _groups(tensors: list) -> dict:
    """Tensors by ``(dtype, device)``, in their order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


@torch.no_grad()
def all_reduce_mean_(tensors: list, group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group`` (None:
    every rank; a mesh's ``data_group``), in place: one flattened
    ``all_reduce`` a dtype (one in an f32 or f64 step)."""
    dist = _dist(group)
    if dist is None:
        return
    world = dist.get_world_size(group)
    for same in _groups(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for t, v in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(v.view_as(t))


def all_reduce_sums(values: list, group=None) -> list:
    """The sums over the ranks of ``group`` (None: every rank) of host
    numbers, in float64 (on the CPU for gloo, on the rank's card for NCCL,
    which takes CUDA tensors only)."""
    dist = _dist(group)
    if dist is None:
        return list(values)
    where = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.float64, device=where)
    dist.all_reduce(t, group=group)
    return t.cpu().tolist()


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers to every rank, in place: one
    flattened broadcast a dtype."""
    dist = _dist()
    if dist is None:
        return
    for group in _groups([*module.parameters(),
                          *module.buffers()]).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def barrier() -> None:
    dist = _dist()
    if dist is not None:
        dist.barrier()


def rank_seed(seed: int, rank: int, world: int) -> int:
    """A rank's own generator seed: ``seed`` itself for one process (so a
    one-process run draws what it always drew), else a hash of it and the
    rank."""
    return seed if world == 1 else NoiseKey(seed).child(f"rank{rank}").seed


def rank_key(root: NoiseKey | None, rank: int, world: int):
    """A rank's own key of coin flips: ``root`` for one process, else its
    child for the rank."""
    if root is None or world == 1:
        return root
    return root.child(f"rank{rank}")
