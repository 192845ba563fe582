"""Host milliseconds the feed's producer thread worked a staged batch in
the traced stretch of the eval window: the program's ``feed.read``
(shard read, stack, pad) and ``feed.stage`` (pinned copy, the copy's
enqueue) spans over its staged batches."""
from harness import program

UNIT, LAYER, MOVES = "ms", "feed: data/shards.py -> data/loader.py", \
    "eval_img_s"


def read(run):
    return program.feed_busy(run, "eval")
