"""Paper Fig. 5: full YCSB suite (A-E) for SD and MD mixes, three systems.

Run E (scans) is the separation-hostile workload: expect RocksDB > Parallax
>> BlobDB on throughput, with Parallax closing most of the gap (paper: within
~40% of RocksDB while BlobDB is ~8x off)."""
from __future__ import annotations

from .common import open_engine, run_phase, scaled_config
from repro_torch.core.ycsb import Workload

SYSTEMS = ["parallax", "rocksdb", "blobdb"]
RUNS = ["run_a", "run_b", "run_c", "run_d"]
KEYS = 10_000


def main(emit, smoke: bool = False) -> None:
    # --smoke (CI): tiny keyspace, SD only, skip the scale-sensitive ordering
    # assertion — the goal is exercising every phase end-to-end in seconds.
    keys = 1200 if smoke else KEYS
    mixes = ("SD",) if smoke else ("SD", "MD")
    scan_ops = 80 if smoke else 600
    scan_kops: dict[str, float] = {}
    for mix in mixes:
        for system in SYSTEMS:
            from .common import AVG_KV

            cfg = scaled_config(system, dataset_keys=keys, avg_kv_bytes=AVG_KV[mix])
            engine = open_engine(cfg)
            load = run_phase(
                f"fig5:{mix}:load_a", system, engine,
                Workload("load_a", mix, num_keys=keys, num_ops=0).load_ops(),
            )
            emit(load.row())
            for run_kind in RUNS:
                w = Workload(run_kind, mix, num_keys=keys, num_ops=keys // 4)
                res = run_phase(f"fig5:{mix}:{run_kind}", system, engine, w.run_ops())
                emit(res.row())
            # Run E: scan-heavy
            w = Workload("run_e", mix, num_keys=keys, num_ops=scan_ops)
            res = run_phase(f"fig5:{mix}:run_e", system, engine, w.run_ops())
            emit(res.row())
            if mix == "SD":
                scan_kops[system] = res.kops
    if smoke:
        return
    # paper Run E ordering: rocksdb > parallax >> blobdb
    assert scan_kops["rocksdb"] > scan_kops["parallax"] > scan_kops["blobdb"], scan_kops
    gap_rocks = scan_kops["rocksdb"] / scan_kops["parallax"]
    gap_blob = scan_kops["parallax"] / scan_kops["blobdb"]
    emit(f"fig5/claims,0,runE_rocksdb_over_parallax={gap_rocks:.2f}x;parallax_over_blobdb={gap_blob:.2f}x")
