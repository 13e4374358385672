"""Real candidate rows per stage-2 pack launched in the window, from the
engine's pack spans."""
from portbench import readers


def read(run):
    return readers.rows_per_pack(run)
