"""The meshes: over ranks, and over one process's devices (counterpart of
``scale_imagenet_tpu/parallel/mesh.py``).

Eval and training run one process per card, so their mesh is over
ranks, not over a process's devices.  ``make_mesh(data, model, world,
rank)`` lays the ranks out as JAX lays its devices out,
``devices[:data*model].reshape(data, model)`` with the model axis
innermost: rank ``r`` sits at data index ``r // model`` and model index
``r % model``.  ``--mesh_data -1`` means ``world
// model``; a mesh larger than the world, or a world that the model axis
does not divide, raises the JAX package's messages.  A mesh smaller than
the world (the JAX package's submesh of the first N devices) has no
meaning when each process owns one card, and is refused.

The ``Mesh`` is the dict of the axis sizes (JAX's ``mesh.shape``) and
carries the rank's coordinates and its two process groups: ``data_group``
(the ranks that share its model index: gradients, BN statistics and
metrics reduce over it) and ``model_group`` (the ranks that share its data
index: the tensor-parallel classifier's sum).  Without a process group
both are None (nothing to reduce); with one, an axis over the whole world
is the default group (None) and any other axis a group of its own, of
one rank or more.

``--mode serve`` drives several devices from one process, as the JAX
server does: ``make_local_mesh(data, model, devices)`` is JAX's
``make_mesh`` over a list of devices, ``devices[:data*model]`` reshaped
(data, model) with the model axis innermost, with its checks and texts.
There a submesh of the first ``data*model`` devices has a meaning (the
rest stay idle), and it is allowed.  The same device may stand in the
list more than once: its replicas then share it (``parallel/local.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

SUBMESH = ("--mesh_data {data} < the {world} ranks: the JAX package would "
           "take a submesh of its first {data} devices, which has no "
           "meaning when each process owns one card (one process a card); "
           "drop --mesh_data or launch {data} ranks")
SUBMESH_MODEL = ("mesh {data}x{model} < the {world} ranks: the JAX package "
                 "would take a submesh of its first {used} devices, which "
                 "has no meaning when each process owns one card (one "
                 "process a card); drop --mesh_data or launch {used} ranks")


class Mesh(dict):
    """``{"data": D, "model": M}``, and this rank's place in it."""

    def __init__(self, data: int, model: int, rank: int = 0):
        super().__init__(data=data, model=model)
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = self.model_group = None

    def data_ranks(self, model_index: int) -> list:
        """The ranks of one model index (a data group)."""
        return [d * self["model"] + model_index
                for d in range(self["data"])]

    def model_ranks(self, data_index: int) -> list:
        """The ranks of one data index (a model group)."""
        m = self["model"]
        return list(range(data_index * m, (data_index + 1) * m))


def _data_axis(data: int, model: int, n: int, unit: str) -> int:
    """The data axis's size over ``n`` devices (or ranks), with the JAX
    package's checks and texts (``scale_imagenet_tpu/parallel/mesh.py:
    16-27``): -1 means every ``unit`` over the model axis."""
    if model < 1:
        raise ValueError(f"--mesh_model {model}: a count >= 1")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data < 1:
        raise ValueError(f"--mesh_data {data}: -1 (every {unit}) or a "
                         "count >= 1")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than the {n} "
                         "available devices")
    return data


def make_mesh(data: int = -1, model: int = 1, world: int = 1,
              rank: int = 0) -> Mesh:
    """The mesh's axis sizes over ``world`` ranks, in the JAX package's
    order of checks (``scale_imagenet_tpu/parallel/mesh.py:15-29``), with
    this rank's coordinates and, where a process group of several ranks
    exists, its process groups: every rank creates every group that is
    not the whole world, in the same order (``new_group``'s rule), and
    keeps its own; the groups take the default group's backend (gloo
    where ranks share a card, NCCL where each has its own,
    ``multihost.py``)."""
    data = _data_axis(data, model, world, "rank")
    if data * model < world:
        if model == 1:
            raise ValueError(SUBMESH.format(data=data, world=world))
        raise ValueError(SUBMESH_MODEL.format(data=data, model=model,
                                              world=world,
                                              used=data * model))
    mesh = Mesh(data, model, rank)
    if world == 1 or not dist.is_initialized():
        return mesh
    if model > 1:
        for m in range(model):
            group = dist.new_group(mesh.data_ranks(m))
            if m == mesh.model_index:
                mesh.data_group = group
    if data > 1:
        for d in range(data):
            group = dist.new_group(mesh.model_ranks(d))
            if d == mesh.data_index:
                mesh.model_group = group
    return mesh


class LocalMesh(dict):
    """``{"data": D, "model": M}`` over one process's devices:
    ``device(d, m)`` is ``devices[d * M + m]``."""

    def __init__(self, data: int, model: int, devices: list):
        super().__init__(data=data, model=model)
        self.devices = list(devices[:data * model])

    def device(self, d: int, m: int = 0) -> torch.device:
        return self.devices[d * self["model"] + m]


def _indexed(device) -> torch.device:
    """A card named without its index is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_local_mesh(data: int, model: int, devices: list) -> LocalMesh:
    """The (data, model) mesh over ``devices`` in one process: JAX's
    ``make_mesh`` (``scale_imagenet_tpu/parallel/mesh.py:15-29``), its
    submesh of the first ``data*model`` devices included."""
    devices = [_indexed(d) for d in devices]
    data = _data_axis(data, model, len(devices), "device")
    return LocalMesh(data, model, devices)


def local_batch_size(global_batch: int, mesh: dict) -> int:
    """A rank's batch: the global batch over the data axis
    (``scale_imagenet_tpu/parallel/mesh.py:32-39``)."""
    n = mesh["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {n}")
    return global_batch // n
