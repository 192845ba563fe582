"""The multi-process runtime on ``torch.distributed`` (counterpart of
``scale_imagenet_tpu/parallel/multihost.py``).

One process a card.  ``initialize(coordinator_address, num_processes,
process_id)`` joins the process group over ``tcp://`` (the reference's
``--dist-url``), and does nothing for one process, as the JAX function
does.  With the three flags absent, torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) stands in for the JAX
package's cluster auto-detection; a flag that is given wins over it.

Each rank takes ``cuda:LOCAL_RANK % device_count`` before any CUDA call.
``LOCAL_RANK`` comes from torchrun; a rank launched by the flags takes its
index among the ranks of its host (by hostname, in rank order), which the
ranks exchange through the rendezvous's store before the group exists.
The backend follows from the same exchange: NCCL when every rank has a
card of its own (no rank on the CPU, and no two ranks on one card of one
host, the card named by its ``CUDA_VISIBLE_DEVICES`` entry where that is
set); gloo otherwise.  NCCL refuses two ranks on one card, and gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast`` (through the host).  A
machine whose ranks report different hostnames counts as several hosts:
if they then share a card, NCCL's own check refuses it.

The JAX package's ``global_batch`` has no counterpart: each rank keeps
its local batch and runs the unmodified forward on it, and the
collectives of ``parallel/data_parallel.py`` join the ranks' gradients,
statistics and metric sums.
"""

from __future__ import annotations

import os

import torch

_MISSING = ("--num_processes {world} needs {what} (or torchrun's "
            "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)")


def requested_world(num_processes: int | None = None) -> int:
    """The world a run asks for, before any process group exists:
    ``--num_processes``, else torchrun's ``WORLD_SIZE``, else 1."""
    if num_processes is not None:
        return max(int(num_processes), 1)
    return max(int(os.environ.get("WORLD_SIZE", "1")), 1)


_KEY = "scale_imagenet_tpu_torch/{}/{}"
_joined: dict = {}


def local_rank(hosts: list, rank: int) -> int:
    """A rank's index among the ranks of its host (``hosts``: every rank's
    hostname), in rank order."""
    return hosts[:rank].count(hosts[rank])


def card_id(host: str, index: int) -> str:
    """The card ``cuda:index`` of this process on ``host``: its
    ``CUDA_VISIBLE_DEVICES`` entry where that is set (ranks that each see
    one card of several), else the index."""
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    return f"{host}/{visible[index] if index < len(visible) else index}"


def choose_backend(cards: list) -> str:
    """NCCL when every rank has a card of its own (``cards``: every rank's
    ``card_id``, ``""`` for a rank on the CPU), else gloo."""
    own = "" not in cards and len(set(cards)) == len(cards)
    return "nccl" if own else "gloo"


def _gather(store, tag: str, rank: int, world: int, value: str) -> list:
    """Every rank's ``value`` for ``tag``, through the store."""
    store.set(_KEY.format(tag, rank), value)
    keys = [_KEY.format(tag, r) for r in range(world)]
    store.wait(keys)
    return [store.get(k).decode() for k in keys]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device | None = None):
    """Join the process group.  Returns ``(rank, world, device)``: the
    rank's device is ``cuda:LOCAL_RANK % device_count`` (made current), or
    the CPU when ``device`` says so.  One process (``num_processes`` <= 1,
    or no flag and no torchrun environment): ``(0, 1, device)`` and no
    group.  A group that already exists is kept (a program may call
    ``main`` several times in one process); its world must match."""
    import socket

    import torch.distributed as dist

    device = torch.device("cuda" if device is None else device)
    world = requested_world(num_processes)
    if world <= 1 and coordinator_address is None:
        return 0, 1, device
    env = os.environ
    rank = process_id if process_id is not None else env.get("RANK")
    if coordinator_address is None and "MASTER_ADDR" in env \
            and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    missing = [flag for flag, v in (("--process_id", rank),
                                    ("--coordinator_address",
                                     coordinator_address)) if v is None]
    if missing:
        raise ValueError(_MISSING.format(world=world,
                                         what=" and ".join(missing)))
    rank = int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"--process_id {rank} outside the {world} "
                         "processes")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU "
            "unless the caller asks for the CPU (--device cpu)")
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} in "
                f"{dist.get_world_size()} exists; this run asks for rank "
                f"{rank} in {world}")
        if device.type == "cuda":
            device = _joined.get("device") or torch.device(
                "cuda", int(env.get("LOCAL_RANK", rank))
                % torch.cuda.device_count())
            torch.cuda.set_device(device)
        return rank, world, device
    store, _, _ = next(dist.rendezvous(f"tcp://{coordinator_address}",
                                       rank, world))
    host = socket.gethostname()
    hosts = _gather(store, "host", rank, world, host)
    card = ""
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", local_rank(hosts, rank)))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        card = card_id(host, device.index)
    cards = _gather(store, "card", rank, world, card)
    dist.init_process_group(choose_backend(cards), store=store,
                            world_size=world, rank=rank)
    _joined["device"] = device if device.type == "cuda" else None
    return rank, world, device


def backend() -> str | None:
    """The process group's backend, or None for one process."""
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else None


def is_coordinator() -> bool:
    """Rank 0 (or a process without a group): the one that prints, logs
    and writes checkpoints and archives."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
