"""The parallel runtime on ``torch.distributed`` (counterpart of
``scale_imagenet_tpu/parallel/``): one process a card, the mesh over ranks
(``mesh.py``), the process group (``multihost.py``) and the data-parallel
collectives (``data_parallel.py``).  Channel-group tensor parallelism
(``parallel/tp.py``) and spatial partitioning come with later slices."""

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
