"""Paper Fig. 6: Load A (top) and Run A (bottom) across all six KV-size mixes
for Parallax / RocksDB / BlobDB: throughput, amplification, efficiency."""
from __future__ import annotations

from .common import load_then_run

MIXES = ["S", "M", "L", "SD", "MD", "LD"]
SYSTEMS = ["parallax", "rocksdb", "blobdb"]
KEYS = {"S": 20_000, "M": 12_000, "L": 5_000, "SD": 10_000, "MD": 10_000, "LD": 8_000}


def main(emit) -> None:
    amps: dict[tuple[str, str, str], float] = {}
    for mix in MIXES:
        for system in SYSTEMS:
            load, run, _ = load_then_run(
                f"fig6:{mix}", system, mix,
                num_keys=KEYS[mix], num_ops=KEYS[mix] // 2,
                cfg_kw={"dataset_keys": KEYS[mix]},
            )
            emit(load.row())
            emit(run.row())
            amps[(mix, system, "load")] = load.amplification
            amps[(mix, system, "run")] = run.amplification
    # paper claims (Fig. 6): for all mixes except S, Parallax amp < RocksDB on
    # Load A; on Run A Parallax beats both baselines for mixed workloads
    for mix in ("M", "L", "SD", "MD", "LD"):
        assert amps[(mix, "parallax", "load")] < amps[(mix, "rocksdb", "load")], mix
    for mix in ("SD", "MD", "LD"):
        assert amps[(mix, "parallax", "run")] < amps[(mix, "rocksdb", "run")], mix
        assert amps[(mix, "parallax", "run")] < amps[(mix, "blobdb", "run")], mix
    emit("fig6/claims,0,parallax_beats_baselines_on_mixed_runA=true")
