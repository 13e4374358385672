"""Synthetic feeds for the recsys graphs and LM token batches (port of
``repro.data``)."""
