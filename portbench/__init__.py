"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
``run.py`` runs one cell once (see ``harness``)."""
