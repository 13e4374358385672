"""Entry points (port of ``repro.launch``: the serving and training
launchers, and the LM family's per-cell serving programs in ``steps``)."""
