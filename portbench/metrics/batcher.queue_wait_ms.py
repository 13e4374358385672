"""Median of the batcher's own queue_wait_ms histogram over the window
(submit to the group's launch), in ms."""
from portbench import readers


def read(run):
    return readers.queue_wait_p50_ms(run)
