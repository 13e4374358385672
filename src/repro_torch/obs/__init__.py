"""Metrics for the serving runtime (port of ``repro.obs.metrics``; tracing is not ported yet)."""
