"""Parallax core: hybrid KV placement in an LSM store (the paper's contribution).

New call-sites should open these building blocks through the unified engine
API — :func:`repro.api.open` with a declarative :class:`repro.api.EngineConfig`
composing placement, partitioning and execution (see ``docs/api.md``); the
classes below remain public as the engine's substrate and for
maintenance/test surfaces.

Public surface:

* :mod:`repro.core.model` — the paper's I/O-amplification model (Eq. 1-4, R(i))
* :class:`repro.core.store.ParallaxStore` — the store (modes: parallax,
  rocksdb, blobdb, nomerge; MS/ML threshold variants)
* :mod:`repro.core.ycsb` — YCSB workload generation (Table 1 mixes) and the
  batched ``execute`` driver
* :class:`repro.core.shard.ShardedStore` — hash-partitioned batch front-end
  (N independent stores, ``put_many``/``get_many``/merged ``scan``)
* :class:`repro.core.range_shard.RangeShardedStore` — range-partitioned
  front-end (contiguous key ranges, range-local ``scan``, skew-driven
  split/merge rebalancing whose key migration is incremental — double-routed
  reads, per-batch ticks — and whose topology is backed by a persistent
  shard-metadata WAL)
* :class:`repro.core.metalog.MetadataLog` — the shard-metadata WAL
  (synchronous boundary/migration records, replayed by recovery;
  ``crash_after`` fault-injection hook for the crash-point harness)
* per-level bloom filters (:class:`repro.core.lsm.BloomFilter`) let point
  reads skip levels; skips are counted in ``StoreStats.bloom_skips``
* :mod:`repro.core.lifetime` — lifetime-aware value placement: the
  deterministic (crc32-keyed) windowed update-distance sketch
  (:class:`~repro.core.lifetime.LifetimeSketch`) that splits the Large log
  into short/long-lived per-class value logs with per-class GC thresholds,
  the adaptive medium/large cutoff controller
  (:func:`~repro.core.lifetime.propose_cutoffs`), and the exact test oracle
  (:class:`~repro.core.lifetime.LifetimeOracle`); enabled via
  ``StoreConfig(lifetime=LifetimeConfig(...))``
* :class:`repro.core.exec.ShardExecutor` — async pipelined shard execution:
  per-shard FIFO queues on a thread pool, pipelined batches, background
  GC/migration at sequence points, byte-identical to serial execution
  (``ycsb.execute_async`` is the batch driver); pluggable device overlap
  policies (:func:`repro.core.io.overlap_time`: serial / ideal / channels:k)
"""
from .exec import BatchHandle, ShardExecutor
from .io import BLOCK, CHUNK, SEGMENT, Device, DeviceStats, overlap_time
from .lifetime import (
    CLASS_LONG,
    CLASS_SHORT,
    LifetimeConfig,
    LifetimeOracle,
    LifetimeSketch,
    propose_cutoffs,
)
from .logs import Log, LogEntry, Pointer, TransientLog
from .lsm import CAT_LARGE, CAT_MEDIUM, CAT_SMALL, BloomFilter, IndexEntry, Level
from .metalog import CrashPoint, MetadataLog
from .model import (
    T_ML,
    T_SM,
    SizePolicy,
    amplification_inplace,
    amplification_inplace_sum,
    amplification_separated,
    capacity_ratio,
    levels_for_dataset,
    separation_benefit,
)
from .range_shard import MigrationState, RangeShardedStore
from .shard import BaseShardedStore, ShardedStore, route
from .store import ParallaxStore, StoreConfig, StoreStats

__all__ = [
    "BLOCK", "CHUNK", "SEGMENT", "Device", "DeviceStats", "overlap_time",
    "BatchHandle", "ShardExecutor",
    "Log", "LogEntry", "Pointer", "TransientLog",
    "CAT_SMALL", "CAT_MEDIUM", "CAT_LARGE", "BloomFilter", "IndexEntry", "Level",
    "CLASS_SHORT", "CLASS_LONG", "LifetimeConfig", "LifetimeOracle",
    "LifetimeSketch", "propose_cutoffs",
    "CrashPoint", "MetadataLog",
    "T_ML", "T_SM", "SizePolicy",
    "amplification_inplace", "amplification_inplace_sum", "amplification_separated",
    "capacity_ratio", "levels_for_dataset", "separation_benefit",
    "ParallaxStore", "StoreConfig", "StoreStats",
    "BaseShardedStore", "ShardedStore", "MigrationState", "RangeShardedStore", "route",
]
