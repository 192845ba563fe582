"""Share of the device's idle time in the traced stretch of the eval
window that the loop's waits for the feed caused: the program's
``feed.wait`` spans' CUDA-event time (how long the loop's stream sat
idle past the work queued before each wait) over the stretch's idle
gaps, in %."""
from harness import program

UNIT, LAYER, MOVES = "%", "feed: data/shards.py -> data/loader.py", \
    "eval_img_s"


def read(run):
    return program.feed_idle(run, "eval")
