"""The benchmark of ``cfdbench_tpu_torch`` on NVIDIA cards: ``run.py`` runs one
cell of the root ``BENCHMARK.json``; see ``README.md``."""
