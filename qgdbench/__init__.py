"""The benchmark of qgd_tpu_torch: see ``BENCHMARK.json`` and ``run.py``."""
