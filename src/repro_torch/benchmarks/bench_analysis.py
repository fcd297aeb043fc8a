"""Race-detector overhead: run C throughput with ``debug_checks`` off vs on.

Two identical batched YCSB run C phases over a 2-shard async engine, one with
the :mod:`repro_torch.analysis.racecheck` lockset detector attached.  The off row is
a normal gated bench row (the detector must cost *nothing* when disabled — it
is never even imported); the on/off comparison is an informational ``:gate``
row because instrumentation overhead is wall-clock, and wall-clock is not
gated.

Claims asserted:
* the modeled metrics (amplification, kops, probes/op, bloom skips) are
  byte-identical with the detector on and off — observation must not perturb
  the modeled system;
* the instrumented run observes a healthy number of events and zero race
  reports (the engine's clean close raises otherwise).
"""
from __future__ import annotations

import dataclasses

import repro_torch.api as api
from .bench_shard import BATCH, MIX, run_sharded_phase, _row
from .common import AVG_KV, open_engine, scaled_config
from repro_torch.core.ycsb import Workload


def main(emit, smoke: bool = False) -> None:
    keys = 2000 if smoke else 4000
    num_ops = keys // 2
    n = 2
    base = scaled_config("parallax", dataset_keys=keys, avg_kv_bytes=AVG_KV[MIX])
    cfg = dataclasses.replace(
        base,
        l0_capacity=max(base.l0_capacity // n, 1 << 11),
        cache_bytes=base.cache_bytes // n,
        bloom_bits_per_key=10,
    )
    load_w = Workload("load_a", MIX, num_keys=keys, num_ops=0)

    results: dict[bool, dict] = {}
    events = 0
    for debug in (False, True):
        engine = open_engine(cfg, partitioning=f"hash:{n}", execution="async",
                             debug_checks=debug)
        api.execute(engine, load_w.load_ops(), batch_size=BATCH)
        run_c = Workload("run_c", MIX, num_keys=keys, num_ops=num_ops)
        mode = "on" if debug else "off"
        results[debug] = run_sharded_phase(f"analysis:run_c:{mode}", engine,
                                           run_c.run_ops())
        if debug:
            checker = engine.race_checker
            events = checker.events
            assert events > 0, "detector attached but never observed an event"
            assert checker.reports == [], checker.reports
        engine.close()  # clean close raises RaceViolation on any report

    off, on = results[False], results[True]
    # observational transparency: the detector must not move a single modeled
    # number — only wall-clock may differ
    for metric in ("ops", "amp", "kops", "probes_per_op", "bloom_skips"):
        assert on[metric] == off[metric], (metric, on[metric], off[metric])

    # the off row is gated against BENCH_BASELINE.json like any other
    emit(_row(off, n, True))
    overhead = on["wall_s"] / max(off["wall_s"], 1e-9)
    emit(
        "analysis/detector:gate,0,"
        f"overhead_x={overhead:.2f};events={events};"
        f"modeled_metrics_identical=true"
    )
