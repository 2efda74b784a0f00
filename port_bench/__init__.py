"""The benchmark of ``lidbox_tpu_torch`` on an NVIDIA H100: ``run.py``
runs one cell (``BENCHMARK.json``) once. See README.md."""
