"""Host milliseconds a batch that the eval loop waited in ``next()`` of the
feed (``shard_loader`` -> ``device_prefetch``), the benchmark's own span,
averaged over the window's batches."""
from harness import readers

UNIT, LAYER, MOVES = "ms", "feed: data/shards.py -> data/loader.py", \
    "eval_img_s"


def read(run):
    return readers.feed_wait_ms(run, "eval")
