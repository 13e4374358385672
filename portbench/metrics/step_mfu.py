"""Model FLOPs (MaRI form) of the work launched in the profiled sub-window
over the peak rate times the sub-window's seconds, in percent."""
from portbench import readers


def read(run):
    return readers.step_mfu(run)
