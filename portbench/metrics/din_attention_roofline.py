"""din_attention's share of its roofline in the profiled sub-window (fold
and unit together), in percent."""
from portbench import readers


def read(run):
    return readers.roofline(run, "din_attention")
