"""Range vs hash sharding behind one engine API: scan locality, lazy
iterators, and skew-driven rebalancing.

    PYTHONPATH=src python -m repro_torch.examples.range_shard_demo
"""
import repro_torch.api as api
from repro_torch.core import StoreConfig
from repro_torch.core.ycsb import Workload, make_key

STORE = StoreConfig(
    l0_capacity=1 << 13, growth_factor=4, cache_bytes=1 << 17,
    segment_bytes=1 << 17, chunk_bytes=1 << 13, bloom_bits_per_key=10,
)
KEYS = 4000


def main() -> None:
    load = Workload("load_e", "SD", num_keys=KEYS, num_ops=0)
    run_e = Workload("run_e", "SD", num_keys=KEYS, num_ops=1500)
    sample = [make_key(i) for i in range(KEYS)]

    print("=== hash sharding: every scan fans out to all shards ===")
    with api.open(api.EngineConfig(store=STORE, partitioning="hash:4",
                                   batch_size=64)) as hashed:
        api.execute(hashed, load.load_ops())
        api.execute(hashed, run_e.run_ops())
        f = hashed.stats()["frontend"]
        print(f"  scans={f['scans']} probes={f['scan_probes']} "
              f"probes/scan={f['scan_probes'] / max(1, f['scans']):.2f}")
        head = hashed.scan(b"", 100)

    print("=== range sharding: scans touch only overlapping shards ===")
    ranged_part = api.PartitioningConfig.range_for_keys(sample, 4)
    with api.open(api.EngineConfig(store=STORE, partitioning=ranged_part,
                                   batch_size=64)) as ranged:
        api.execute(ranged, load.load_ops())
        api.execute(ranged, run_e.run_ops())
        f = ranged.stats()["frontend"]
        print(f"  scans={f['scans']} probes={f['scan_probes']} "
              f"probes/scan={f['scan_probes'] / max(1, f['scans']):.2f}")
        assert ranged.scan(b"", 100) == head  # partitioning is invisible

        print("=== lazy iterator: stream rows without materializing scans ===")
        it = ranged.iterator(make_key(KEYS // 2))
        rows = 0
        while it.valid() and rows < 5:
            print(f"  {it.key()[:12].decode()}... {len(it.value())}B")
            it.next()
            rows += 1

    print("=== skew repair: a degenerate one-hot map splits under load ===")
    adaptive_cfg = api.EngineConfig(
        store=STORE,
        partitioning=api.PartitioningConfig(
            scheme="range", shards=4, rebalance_window=500, max_shards=16),
        batch_size=64,
    )
    with api.open(adaptive_cfg) as adaptive:
        store = adaptive.store
        one_hot = {store.shard_of(make_key(i)) for i in range(KEYS)}
        print(f"  before: all {KEYS} keys land on shard(s) {sorted(one_hot)}")
        api.execute(adaptive, load.load_ops())
        api.execute(adaptive, run_e.run_ops())
        topo = adaptive.stats()["topology"]
        per_shard = [
            len(s.live_keys_in(*store.bounds(i))) for i, s in enumerate(store.shards)
        ]
        print(f"  after:  splits={topo['splits']} merges={topo['merges']} "
              f"migrated={topo['migrated_keys']} keys/shard={per_shard}")

        print("=== crash mid-everything: prefix-consistent recovery per shard ===")
        adaptive.flush_all()
        cutoffs = adaptive.crash()
        adaptive.recover()
        head = [k[:10] for k, _ in adaptive.scan(b"", 3)]
        print(f"  recovered {len(cutoffs)} shards; scan head: {head}")


if __name__ == "__main__":
    main()
