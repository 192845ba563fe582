"""The parallel runtime on ``torch.distributed`` (counterpart of
``scale_imagenet_tpu/parallel/``): one process a card, the (data, model)
mesh over ranks and its process groups (``mesh.py``), the process group
(``multihost.py``), the data-parallel collectives over the data axis
(``data_parallel.py``), channel-group tensor parallelism over the model
axis (``tp.py``, imported from there) and spatial partitioning over it
(``sp.py``, ``--sp``: the counterpart of ``sharding.py::
spatial_sharding``).  ``sharding.py``'s other GSPMD rules have no
counterpart (nothing in the JAX package calls them)."""

from .data_parallel import all_reduce_mean_, all_reduce_sums, barrier, \
    broadcast_module_, rank_key, rank_seed
from .mesh import local_batch_size, make_mesh
from .multihost import backend, initialize, is_coordinator, requested_world
from .sp import SP_FAMILY, RowShard, fetch_rows, gather_rows, local_rows, \
    row_bounds, row_shard, sp_forward, sp_ttnet_imagenet_apply

__all__ = [
    "all_reduce_mean_", "all_reduce_sums", "barrier", "broadcast_module_",
    "rank_key", "rank_seed",
    "local_batch_size", "make_mesh", "backend", "initialize",
    "is_coordinator", "requested_world",
    "SP_FAMILY", "RowShard", "fetch_rows", "gather_rows", "local_rows",
    "row_bounds", "row_shard", "sp_forward", "sp_ttnet_imagenet_apply",
]
