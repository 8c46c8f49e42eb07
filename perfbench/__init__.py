"""The benchmark of the PyTorch port (``repro_torch``) on one H100:
``run.py`` runs one cell of ``BENCHMARK.json``."""
