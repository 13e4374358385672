"""95th percentile of the latency of every request of the window, due (or
copied in) to scores on the host, in ms (host clock)."""
from portbench import readers


def read(run):
    return readers.p95_ms(run)
