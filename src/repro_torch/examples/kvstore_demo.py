"""Parallax KV-store walkthrough on the unified engine API: hybrid placement,
write batches, iterators, GC, crash recovery.

    PYTHONPATH=src python -m repro_torch.examples.kvstore_demo
"""
import repro_torch.api as api
from repro_torch.core import StoreConfig
from repro_torch.core.ycsb import Workload, payload


def main() -> None:
    cfg = api.EngineConfig(store=StoreConfig(
        mode="parallax", l0_capacity=1 << 14, growth_factor=4,
        cache_bytes=1 << 17, segment_bytes=1 << 17, chunk_bytes=1 << 13,
    ))
    with api.open(cfg) as db:
        print("=== load a medium-dominated workload ===")
        api.execute(db, Workload("load_a", "MD", num_keys=5000, num_ops=0).load_ops())
        s = db.store.checkpoint_stats()
        print(f"levels={s['levels']} medium_segments={s['medium_log_segments']} "
              f"large_segments={s['large_log_segments']} amp={s['amplification']:.2f}")

        print("=== a write batch across the three categories ===")
        with db.write_batch() as wb:
            wb.put(b"small-key-000000000000", payload(9))
            wb.put(b"medium-key-00000000000", payload(104))
            wb.put(b"large-key-000000000000", payload(1004))
        for k in (b"small-key-000000000000", b"medium-key-00000000000", b"large-key-000000000000"):
            v = db.get(k)
            print(f"  get {k.decode():24s} -> {len(v)}B")

        print("=== updates create garbage; GC reclaims large-log segments ===")
        for _ in range(3):
            with db.write_batch() as wb:
                for i in range(500):
                    wb.update(f"user{i:019d}".encode(), payload(1004))
        before = len(db.store.large_log.segments)
        reclaimed = db.gc_tick()
        stats = db.stats()["store"]
        print(f"  segments before={before} reclaimed={reclaimed} "
              f"gc_lookups={stats['gc_lookups']} relocations={stats['gc_relocations']}")

        print("=== crash / prefix-consistent recovery ===")
        db.put(b"durable-key-0000000000", payload(104))
        cutoff = db.crash()
        db.recover()
        it = db.iterator()
        head = []
        while it.valid() and len(head) < 3:
            head.append(it.key()[:12])
            it.next()
        print(f"  recovered to LSN {cutoff} (of {db.store.lsn}); scan head: {head}")
        print(f"final amplification: {db.amplification():.2f}")


if __name__ == "__main__":
    main()
