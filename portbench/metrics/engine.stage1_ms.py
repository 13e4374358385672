"""Host ms per stage-1 run, the device's wait included (StageProfiler
stage1 total over calls) in the window."""
from portbench import readers


def read(run):
    return readers.phase_ms(run, "stage1")
