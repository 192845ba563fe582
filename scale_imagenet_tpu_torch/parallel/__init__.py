"""The parallel runtime (counterpart of ``scale_imagenet_tpu/parallel/``):
on ``torch.distributed`` one process a card, the (data, model) mesh over
ranks and its process groups (``mesh.py``), the process group
(``multihost.py``), the data-parallel collectives over the data axis
(``data_parallel.py``), channel-group tensor parallelism over the model
axis (``tp.py``, imported from there) and spatial partitioning over it
(``sp.py``'s row ops and ``sp_models.py``'s forwards, ``--sp``: the
counterpart of ``sharding.py::spatial_sharding``); in one process, for
``--mode serve``, the mesh over its devices (``mesh.py::
make_local_mesh``) and the placements and exchange over them
(``local.py``: the counterpart of ``sharding.py``'s ``batch_sharding``,
``replicate`` and ``shard_map_dp_apply``).  ``sharding.py``'s other GSPMD
rules have no counterpart (nothing in the JAX package calls them)."""

from .data_parallel import all_reduce_mean_, all_reduce_sums, barrier, \
    broadcast_module_, rank_key, rank_seed
from .local import LocalGroup, gather_probs, replicate, split_batch
from .mesh import LocalMesh, local_batch_size, make_local_mesh, make_mesh
from .multihost import backend, initialize, is_coordinator, requested_world
from .sp import RowShard, fetch_rows, gather_rows, local_rows, row_bounds, \
    row_shard
from .sp_models import SP_FAMILIES, sp_forward, sp_interval_logits, \
    sp_ttnet_imagenet_apply

__all__ = [
    "all_reduce_mean_", "all_reduce_sums", "barrier", "broadcast_module_",
    "rank_key", "rank_seed",
    "LocalGroup", "gather_probs", "replicate", "split_batch",
    "LocalMesh", "local_batch_size", "make_local_mesh", "make_mesh",
    "backend", "initialize",
    "is_coordinator", "requested_world",
    "RowShard", "fetch_rows", "gather_rows", "local_rows", "row_bounds",
    "row_shard", "SP_FAMILIES", "sp_forward", "sp_interval_logits",
    "sp_ttnet_imagenet_apply",
]
