"""gather_einsum's share of its roofline in the profiled sub-window (every
entry the path launches), in percent."""
from portbench import readers


def read(run):
    return readers.roofline(run, "gather_einsum")
