"""The benchmark of ``vortex_rt_tpu_torch``: one run of one cell of
``BENCHMARK.json`` a process (``python -m rtbench.run``).  See
``rtbench/README.md``."""
