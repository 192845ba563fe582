from .evaluate import evaluate
from .server import DynamicBatcher, make_forward, serve

__all__ = ["DynamicBatcher", "evaluate", "make_forward", "serve"]
