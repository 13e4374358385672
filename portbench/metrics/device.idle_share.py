"""Share of the profiled sub-window with no device op running, in percent."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
