"""Host ms per pack (StageProfiler pack total over calls) in the window."""
from portbench import readers


def read(run):
    return readers.phase_ms(run, "pack")
