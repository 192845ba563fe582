from .checkpoint import CheckpointManager, load_train_state, \
    save_checkpoint, train_payload
from .evaluate import evaluate
from .server import DynamicBatcher, make_forward, serve

__all__ = ["CheckpointManager", "DynamicBatcher", "evaluate",
           "load_train_state", "make_forward", "save_checkpoint", "serve",
           "train_payload"]
