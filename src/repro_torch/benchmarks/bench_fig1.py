"""Paper Fig. 1: I/O amplification for small KV inserts — BlobDB with GC,
BlobDB without GC, RocksDB (and Parallax for reference).

Expected trend (paper: 27.4 / 2.1 / 17.4): KV separation without GC is far
cheaper than in-place, but GC *identification* alone (pure-insert load!)
pushes BlobDB past RocksDB."""
from __future__ import annotations

from .common import open_engine, run_phase, scaled_config
from repro_torch.core.ycsb import Workload

KEYS = 30_000


def main(emit) -> None:
    results = {}
    for system, mode, auto_gc in [
        ("blobdb_gc", "blobdb", True),
        ("blobdb_nogc", "blobdb", False),
        ("rocksdb", "rocksdb", True),
        ("parallax", "parallax", True),
    ]:
        cfg = scaled_config(mode, dataset_keys=KEYS, auto_gc=auto_gc, avg_kv_bytes=33)
        engine = open_engine(cfg)
        w = Workload("load_a", "S", num_keys=KEYS, num_ops=0)
        res = run_phase("fig1:small_load", system, engine, w.load_ops())
        results[system] = res.amplification
        emit(res.row())
    # paper claims: blobdb_gc > rocksdb > blobdb_nogc; >13x gap with/without GC
    assert results["blobdb_gc"] > results["rocksdb"], results
    assert results["blobdb_gc"] / results["blobdb_nogc"] > 3.0, results
    emit(
        f"fig1/claims,0,blobdb_gc_over_nogc={results['blobdb_gc']/results['blobdb_nogc']:.1f}x;"
        f"blobdb_gc_vs_rocksdb={results['blobdb_gc']/results['rocksdb']:.2f}x"
    )
