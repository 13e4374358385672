"""Candidates scored by the requests completed in the window, per second of
the window (host clock)."""
from portbench import readers


def read(run):
    return readers.cands_per_s(run)
