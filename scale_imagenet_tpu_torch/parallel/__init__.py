"""The parallel runtime on ``torch.distributed`` (counterpart of
``scale_imagenet_tpu/parallel/``): one process a card, the (data, model)
mesh over ranks and its process groups (``mesh.py``), the process group
(``multihost.py``), the data-parallel collectives over the data axis
(``data_parallel.py``) and channel-group tensor parallelism over the model
axis (``tp.py``, imported from there).  Spatial partitioning (``--sp``)
comes with the next slice; ``sharding.py``'s GSPMD rules have no
counterpart (nothing in the JAX package calls them)."""

from .data_parallel import all_reduce_mean_, all_reduce_sums, barrier, \
    broadcast_module_, rank_key, rank_seed
from .mesh import local_batch_size, make_mesh
from .multihost import backend, initialize, is_coordinator, requested_world

__all__ = [
    "all_reduce_mean_", "all_reduce_sums", "barrier", "broadcast_module_",
    "rank_key", "rank_seed",
    "local_batch_size", "make_mesh", "backend", "initialize",
    "is_coordinator", "requested_world",
]
