"""Seconds from the process's start to the window's start: kernel build or
load, weights and traffic drawn, the system built, every shape warmed
(host clock)."""


def read(run):
    return run.setup_s
