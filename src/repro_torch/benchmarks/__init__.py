"""Benchmarks through the port's store engine, copied from the repository's
``benchmarks/`` with imports renamed.  ``bench_ycsb.main(emit, smoke=True)``
emits the fig5 rows that ``common.baseline_mismatches`` holds to
``BENCH_BASELINE.json``."""
