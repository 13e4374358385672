"""Entry points (port of ``repro.launch``: the serving and training
launchers)."""
