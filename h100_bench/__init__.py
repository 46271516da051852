"""The benchmark of ``pim_embedding_lookup_tpu_torch`` on NVIDIA H100s
(``run.py``); ``BENCHMARK.json`` at the repository's root lists its cells."""
