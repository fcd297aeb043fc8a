"""The benchmarks' shared machinery, copied from ``benchmarks/common.py`` with
its imports renamed, so that a bench drives ``repro_torch.api`` engines: the
scaled store config, ``open_engine``, ``BenchResult``, the metric extraction
and ``run_phase`` (the rest is not copied yet).  Plus
``baseline_mismatches``, which holds emitted rows to ``BENCH_BASELINE.json``.

Metrics:
* amplification  — device traffic / application traffic (the paper's metric)
* kops           — ops / simulated device time (P4800X bandwidths); a device-
                   bound throughput proxy
* kcycles_per_op — modeled CPU cost: documented constants x op counters
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import repro_torch.api as api
from repro_torch.core import ParallaxStore, StoreConfig

# modeled CPU constants (cycles); see module docstring
C_OP = 2_000          # per user op (parse, memtable, WAL append)
C_PROBE = 2_500       # per index leaf probe (search + fault amortized)
C_MERGE = 150         # per entry merged in compaction
C_GC_LOOKUP = 3_000   # per GC validity lookup
C_BYTE = 0.1          # per device byte (checksum/memcpy share)
CLOCK_HZ = 3.2e9      # paper testbed cores


AVG_KV = {"S": 33, "M": 128, "L": 1028, "SD": 251, "MD": 289, "LD": 649}


def scaled_config(mode: str, *, growth_factor: int = 4, dataset_keys: int = 20_000,
                  cache_frac: float = 0.2, merge_depth: int = 1,
                  sorted_segments: bool = True, t_sm: float = 0.2, t_ml: float = 0.02,
                  auto_gc: bool = True, avg_kv_bytes: int = 250) -> StoreConfig:
    # growth_factor 4 + 16 KB L0 gives the scaled datasets the same 3-4 level
    # depth as the paper's 10-100 GB datasets (level count drives level
    # amplification, Eq. 2) — see EXPERIMENTS.md §Scaling.
    approx_bytes = dataset_keys * avg_kv_bytes
    return StoreConfig(
        mode=mode,
        t_sm=t_sm,
        t_ml=t_ml,
        l0_capacity=1 << 14,
        growth_factor=growth_factor,
        merge_depth=merge_depth,
        sorted_segments=sorted_segments,
        cache_bytes=int(approx_bytes * cache_frac),
        segment_bytes=1 << 17,
        chunk_bytes=1 << 13,
        auto_gc=auto_gc,
    )


def open_engine(store_config: StoreConfig, **engine_kw) -> api.Engine:
    """One-liner for the benches: an engine over a scaled store config."""
    return api.open(api.EngineConfig(store=store_config, **engine_kw))


@dataclasses.dataclass
class BenchResult:
    name: str
    system: str
    ops: int
    amplification: float
    kops: float
    kcycles_per_op: float
    wall_s: float
    cfg: str = ""
    extra: dict = dataclasses.field(default_factory=dict)

    def row(self) -> str:
        us_per_call = 1e6 * self.wall_s / max(self.ops, 1)
        ident = f"{self.name}/{self.system}"
        if self.cfg:
            ident = f"{ident}@{self.cfg}"
        return (
            f"{ident},{us_per_call:.2f},"
            f"amp={self.amplification:.2f};kops={self.kops:.1f};"
            f"kcyc_op={self.kcycles_per_op:.1f}"
        )


def metrics(store: ParallaxStore, ops: int, *, since=None, app_since: int = 0,
            ops_breakdown=None) -> tuple[float, float, float]:
    dstats = store.device.stats if since is None else store.device.stats.delta(since)
    app = store.stats.app_bytes - app_since
    amp = dstats.total / max(app, 1)
    dev_time = store.device.device_time(dstats)
    s = store.stats
    cycles = (
        C_OP * ops
        + C_PROBE * s.index_probes
        + C_MERGE * s.entries_merged
        + C_GC_LOOKUP * s.gc_lookups
        + C_BYTE * dstats.total
    )
    cpu_time = cycles / CLOCK_HZ
    kops = ops / max(dev_time, cpu_time, 1e-9) / 1e3
    kcyc = cycles / max(ops, 1) / 1e3
    return amp, kops, kcyc


def run_phase(name: str, system: str, engine: api.Engine, workload_ops,
              ops_count_hint=None) -> BenchResult:
    """One workload phase through a none-partitioned engine (bare store)."""
    store = engine.store
    t0 = time.time()
    since = store.device.stats.snapshot()
    app0 = store.stats.app_bytes
    # zero op-counters for a clean phase measurement
    store.stats.index_probes = 0
    store.stats.entries_merged = 0
    store.stats.gc_lookups = 0
    counts = api.execute(engine, workload_ops)
    ops = sum(counts.values())
    amp, kops, kcyc = metrics(store, ops, since=since, app_since=app0)
    return BenchResult(name, system, ops, amp, kops, kcyc, time.time() - t0,
                       cfg=engine.config.tag())


def baseline_mismatches(rows: list[str], baseline: Path) -> list[str]:
    """Rows whose derived metrics differ from the baseline row of the same
    name (or that the baseline lacks); the timing column is not compared."""
    expect = {r["name"]: r["derived"] for r in json.loads(Path(baseline).read_text())["rows"]}
    bad = []
    for row in rows:
        name, _, derived = row.split(",", 2)
        if expect.get(name) != derived:
            bad.append(f"{name}: got {derived!r}, baseline {expect.get(name)!r}")
    return bad
