"""Entry points (port of ``repro.launch``: the serving and training
launchers, and the per-cell programs of the LM and recsys families in
``steps``)."""
