"""Synthetic feeds for the recsys graphs (port of ``repro.data``)."""
