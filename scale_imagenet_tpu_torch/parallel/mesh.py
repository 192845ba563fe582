"""The data-parallel mesh over ranks (counterpart of
``scale_imagenet_tpu/parallel/mesh.py``).

The port runs one process per card, so its mesh is over ranks, not over a
process's devices: ``--mesh_data -1`` means every rank, and a data axis
larger than the world raises the JAX package's ``make_mesh`` message.  A
data axis smaller than the world (the JAX package's submesh of the first
N devices) has no meaning when each process owns one card, and is
refused.  ``--mesh_model`` > 1 (channel-group tensor parallelism, spatial
partitioning) comes with later slices.
"""

from __future__ import annotations

MESH_MODEL = ("not ported yet: --mesh_model {model} (channel-group tensor "
              "parallelism and spatial partitioning come with later "
              "slices; see ROADMAP.md)")
SUBMESH = ("--mesh_data {data} < the {world} ranks: the JAX package would "
           "take a submesh of its first {data} devices, which has no "
           "meaning when each process owns one card (one process a card); "
           "drop --mesh_data or launch {data} ranks")


def make_mesh(data: int = -1, model: int = 1, world: int = 1) -> dict:
    """The mesh's axis sizes ``{"data": D, "model": 1}`` over ``world``
    ranks, in the JAX package's order of checks
    (``scale_imagenet_tpu/parallel/mesh.py:15-29``)."""
    if model != 1:
        raise ValueError(MESH_MODEL.format(model=model))
    if data == -1:
        data = world
    if data < 1:
        raise ValueError(f"--mesh_data {data}: -1 (every rank) or a count "
                         ">= 1")
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs more than the {world} "
                         "available devices")
    if data < world:
        raise ValueError(SUBMESH.format(data=data, world=world))
    return {"data": data, "model": model}


def local_batch_size(global_batch: int, mesh: dict) -> int:
    """A rank's batch: the global batch over the data axis
    (``scale_imagenet_tpu/parallel/mesh.py:32-39``)."""
    n = mesh["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {n}")
    return global_batch // n
