"""Fault tolerance (port of ``repro.ft``: the retry policy the batcher uses)."""
