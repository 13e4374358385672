"""Entry points (port of ``repro.launch``: the serving launcher)."""
