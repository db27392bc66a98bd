"""The benchmark of the PyTorch and CUDA port, fandom_search_tpu_torch.

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness/`` holds the
general code (generator, window, trace reduction, rooflines, the
comparison), and each configuration, traffic mix, per-layer metric and
plain reference is a file of its own, found by name: ``configs/``,
``traffic/``, ``metrics/``, ``reference/``.
"""
