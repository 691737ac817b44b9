"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

`run.py` runs one cell once on the card and prints one JSON line; the
cells, configurations, traffic and metrics are the data files under
``workloads/``, ``configs/``, ``traffic/`` and ``metrics/``, found by the
names in the repository's `BENCHMARK.json`. The harness (`serve`,
`train`, `profiling`, `work`, `check`) and the plain references
(`reference/`) stay fixed; nothing here imports JAX or the JAX package.
"""
