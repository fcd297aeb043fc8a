"""The benchmark's harness: one run of one cell of ``BENCHMARK.json`` (``bench/run.py``)."""
