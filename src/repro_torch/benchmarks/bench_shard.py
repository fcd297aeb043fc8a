"""Sharded batch front-end: throughput/amplification vs shard count and blooms.

Drives YCSB runs A/B/C through :class:`repro_torch.core.shard.ShardedStore` with the
batched ``execute`` path for every combination of shard count (1/2/4/8) and
per-level bloom filters (on/off), against a seed-style baseline (one bare
``ParallaxStore``, blooms off, per-op execute).

Throughput model: shards are independent devices and cores, so device time is
the max over shards and modeled CPU cycles are divided across shards.

Claims asserted:
* batched run C with blooms pays fewer index probes per op than the seed
  single-store path (the filters skip levels that cannot hold the key);
* ``ShardedStore(num_shards=1)`` returns get/scan results identical to a bare
  ``ParallaxStore`` over the same workload.
"""
from __future__ import annotations

import dataclasses
import time

import repro_torch.api as api
from .common import AVG_KV, C_BYTE, C_GC_LOOKUP, C_MERGE, C_OP, C_PROBE, CLOCK_HZ, open_engine, run_phase, scaled_config
from .common import run_async_claim
from repro_torch.core.ycsb import Workload, make_key

MIX = "SD"
# run E makes the hash-shard scan fan-out cost visible: every scan must probe
# all N shards (k-way merge), the baseline bench_range's range partitioning
# beats
RUNS = ("run_a", "run_b", "run_c", "run_e")
BATCH = 64


def _reset_op_counters(store) -> None:
    for s in store.shards:
        s.stats.index_probes = 0
        s.stats.bloom_skips = 0
        s.stats.entries_merged = 0
        s.stats.gc_lookups = 0


def run_sharded_phase(name: str, engine: api.Engine, ops, batch: int = BATCH) -> dict:
    store = engine.store
    t0 = time.time()
    snaps = [s.device.stats.snapshot() for s in store.shards]
    app0 = sum(s.stats.app_bytes for s in store.shards)
    _reset_op_counters(store)
    counts = api.execute(engine, ops, batch_size=batch)
    nops = sum(counts.values())
    deltas = [s.device.stats.delta(sn) for s, sn in zip(store.shards, snaps)]
    total_bytes = sum(d.total for d in deltas)
    app = sum(s.stats.app_bytes for s in store.shards) - app0
    agg = store.aggregate_stats()
    cycles = (
        C_OP * nops
        + C_PROBE * agg.index_probes
        + C_MERGE * agg.entries_merged
        + C_GC_LOOKUP * agg.gc_lookups
        + C_BYTE * total_bytes
    )
    dev_time = max(s.device.device_time(d) for s, d in zip(store.shards, deltas))
    cpu_time = cycles / CLOCK_HZ / store.num_shards  # one core per shard
    return {
        "name": name,
        "ops": nops,
        "amp": total_bytes / max(app, 1),
        "kops": nops / max(dev_time, cpu_time, 1e-9) / 1e3,
        "probes_per_op": agg.index_probes / max(nops, 1),
        "bloom_skips": agg.bloom_skips,
        "wall_s": time.time() - t0,
        "cfg": engine.config.tag(),
    }


def _row(r: dict, shards: int, bloom: bool) -> str:
    us = 1e6 * r["wall_s"] / max(r["ops"], 1)
    return (
        f"{r['name']}/parallax-x{shards}{'+bloom' if bloom else ''}@{r['cfg']},{us:.2f},"
        f"amp={r['amp']:.2f};kops={r['kops']:.1f};"
        f"probes_op={r['probes_per_op']:.2f};bloom_skips={r['bloom_skips']}"
    )


def main(emit, smoke: bool = False) -> None:
    # smoke keeps enough keys that the 1-shard tree has >= 2 levels (blooms
    # have nothing to skip in a single-level tree)
    keys = 2000 if smoke else 4000
    num_ops = keys // 2
    shard_counts = (1, 2) if smoke else (1, 2, 4, 8)
    base_cfg = scaled_config("parallax", dataset_keys=keys, avg_kv_bytes=AVG_KV[MIX])

    # seed-style baseline: one store, blooms off, per-op execute
    seed_cfg = dataclasses.replace(base_cfg, bloom_bits_per_key=0)
    seed = open_engine(seed_cfg)
    load_w = Workload("load_a", MIX, num_keys=keys, num_ops=0)
    emit(run_phase("shard:seed:load_a", "parallax-seed", seed, load_w.load_ops()).row())
    seed_probes: dict[str, float] = {}
    for run_kind in RUNS:
        w = Workload(run_kind, MIX, num_keys=keys, num_ops=num_ops)
        res = run_phase(f"shard:seed:{run_kind}", "parallax-seed", seed, w.run_ops())
        seed_probes[run_kind] = seed.store.stats.index_probes / max(res.ops, 1)
        emit(res.row())

    probes_run_c: dict[tuple[bool, int], float] = {}
    bloom_skips_run_c: dict[int, int] = {}
    for bloom in (False, True):
        for n in shard_counts:
            # fixed TOTAL memory budget across the fleet: L0 and cache are
            # split over the shards (otherwise per-shard trees collapse to a
            # single level and the bloom dimension measures nothing for n>1)
            cfg = dataclasses.replace(
                base_cfg,
                l0_capacity=max(base_cfg.l0_capacity // n, 1 << 11),
                cache_bytes=base_cfg.cache_bytes // n,
                bloom_bits_per_key=10 if bloom else 0,
            )
            engine = open_engine(cfg, partitioning=f"hash:{n}")
            tag = f"x{n}{'b' if bloom else ''}"
            r = run_sharded_phase(f"shard:{tag}:load_a", engine, load_w.load_ops())
            emit(_row(r, n, bloom))
            for run_kind in RUNS:
                w = Workload(run_kind, MIX, num_keys=keys, num_ops=num_ops)
                r = run_sharded_phase(f"shard:{tag}:{run_kind}", engine, w.run_ops())
                emit(_row(r, n, bloom))
                if run_kind == "run_c":
                    probes_run_c[(bloom, n)] = r["probes_per_op"]
                    if bloom:
                        bloom_skips_run_c[n] = r["bloom_skips"]

    # claim 1: filters do real work on the read-only run — at every shard
    # count blooms fire and cut probes/op vs the same config without them,
    # and the batched 1-shard bloom path beats the seed single-store path
    # (same tree shape, so the delta is purely the filters)
    for n in shard_counts:
        assert bloom_skips_run_c[n] > 0, (n, bloom_skips_run_c)
        assert probes_run_c[(True, n)] < probes_run_c[(False, n)], (n, probes_run_c)
    assert probes_run_c[(True, 1)] < seed_probes["run_c"], (probes_run_c, seed_probes)
    emit(
        "shard/claims,0,"
        f"runC_probes_seed={seed_probes['run_c']:.2f};"
        f"runC_probes_bloom_x1={probes_run_c[(True, 1)]:.2f};"
        f"runC_bloom_vs_nobloom_all_shards=lower"
    )

    # claim 3 (PR 4, acceptance): the async engine realizes the overlap the
    # device model promises — paced wall-clock batch throughput on run C at 4
    # shards with 4 workers is >= 2x the 1-worker serialization of the same
    # engine, and the modeled overlap policies bracket the measurement
    async_n, async_workers = 4, 4
    async_cfg = dataclasses.replace(
        base_cfg,
        l0_capacity=max(base_cfg.l0_capacity // async_n, 1 << 11),
        cache_bytes=base_cfg.cache_bytes // async_n,
        bloom_bits_per_key=10,
    )

    def make_async_engine(execution: api.ExecutionConfig) -> api.Engine:
        eng = open_engine(async_cfg, partitioning=f"hash:{async_n}", execution=execution)
        api.execute(eng, load_w.load_ops(), batch_size=BATCH)
        return eng

    run_c = lambda: Workload("run_c", MIX, num_keys=keys, num_ops=num_ops).run_ops()
    run_async_claim(emit, "shard:async",
                    f"shard:async:run_c/parallax-x{async_n}w{async_workers}",
                    make_async_engine, run_c, workers=async_workers, batch=BATCH)

    # claim 2: a 1-shard bloom-filtered front-end is indistinguishable from the
    # bare filterless store (routing + batching + filters change no results)
    bare = open_engine(dataclasses.replace(base_cfg, bloom_bits_per_key=0))
    front = open_engine(dataclasses.replace(base_cfg, bloom_bits_per_key=10),
                        partitioning="hash:1")
    api.execute(bare, load_w.load_ops())
    api.execute(front, load_w.load_ops(), batch_size=BATCH)
    probe_keys = [make_key(i) for i in range(keys + 10)]
    assert [front.get(k) for k in probe_keys] == [bare.get(k) for k in probe_keys]
    assert front.scan(b"", keys + 10) == bare.scan(b"", keys + 10)
    emit(f"shard/claims,0,n1_equivalent_to_bare_store=true;keys={keys}")
