"""mari_matmul's share of its roofline in the profiled sub-window, in
percent."""
from portbench import readers


def read(run):
    return readers.roofline(run, "mari_matmul")
