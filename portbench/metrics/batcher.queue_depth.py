"""Median of the requests queued when each group of the window opened
(``batcher.linger``'s ``depth``)."""
from portbench import attribution


def read(run):
    return attribution.queue_depth(run)
