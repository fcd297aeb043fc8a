"""Parallax: an LSM KV store with hybrid key-value placement (paper §3).

One class implements all four system modes evaluated in the paper:

* ``parallax`` — hybrid placement: small in place, large in the Large log
  (with segment GC), medium in the transient log merged in place at the last
  ``merge_depth`` level(s)  (§3.1–§3.3).
* ``rocksdb``  — everything in place (the RocksDB baseline).
* ``blobdb``   — full KV separation: everything in the value log, periodic
  scan-30% GC after compactions (the BlobDB baseline).
* ``nomerge``  — Fig. 8's non-achievable ideal: mediums stay in the log
  forever, no GC and no in-place merge.

Parallax-MS / Parallax-ML (Fig. 7) are the ``parallax`` mode with collapsed
thresholds (``t_sm == t_ml``).

The store is functionally correct (put/get/update/delete/scan with LSN
ordering, tombstones, crash/recover) and every byte that would touch the
device flows through :class:`repro.core.io.Device`, which is how the
benchmarks reproduce the paper's amplification numbers.

Read path: point lookups consult a per-level bloom filter (rebuilt with each
compaction, ``StoreConfig.bloom_bits_per_key``; 0/off by default so the bare
store reproduces the paper's filterless index) before paying the leaf probe;
skipped levels are counted in ``StoreStats.bloom_skips``.  All hashing on the
read path (cache-block choice, bloom probes) uses ``zlib.crc32`` so traffic
and stats are bit-identical across processes — ``hash()`` is randomized by
``PYTHONHASHSEED`` and must not be used here.

For the sharded batch front-end layered on top of this class see
:class:`repro.core.shard.ShardedStore`.

Thread-safety audit (PR 4, see docs/execution.md): a ``ParallaxStore`` is
**single-threaded by contract** — nothing in here takes a lock.  ``StoreStats``
counter bumps, ``BlockCache``'s ``OrderedDict`` LRU moves, ``Device`` byte
accounting, L0 dict mutation, level rebuilds and log segment lists are all
plain mutations that would race under concurrent callers.  The async engine
(:class:`repro.core.exec.ShardExecutor`) therefore never lets two tasks touch
one store: every task runs on its shard's FIFO queue (a migration's src/dst
pair shares one queue, since double-routed reads touch both), and each task
additionally asserts exclusivity with a non-blocking per-store lock acquire —
a failed acquire means the shard-independence invariant broke, and the
executor raises rather than silently corrupting stats.  ``flush_all``/
``crash``/``recover`` and topology mutations run only at executor sequence
points (no tasks in flight).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import zlib
from typing import Iterable, Iterator

from .io import BLOCK, SEGMENT, Device
from .lifetime import CLASS_LONG, CLASS_SHORT, LifetimeConfig, LifetimeSketch, propose_cutoffs
from .logs import Log, LogEntry, Pointer, TransientLog
from .lsm import CAT_LARGE, CAT_MEDIUM, CAT_SMALL, IndexEntry, Level, merge_runs
from .model import SizePolicy

# virtual address regions so leaf probes of different levels hit different
# cache blocks (logs get their own offsets from the allocator)
_LEVEL_REGION = 1 << 40


@dataclasses.dataclass
class StoreStats:
    inserts: int = 0
    updates: int = 0
    deletes: int = 0
    gets: int = 0
    scans: int = 0
    found: int = 0
    app_bytes: int = 0          # application traffic (user KV bytes in+out)
    index_probes: int = 0       # binary-search leaf probes
    bloom_skips: int = 0        # levels skipped by a negative bloom answer
    entries_merged: int = 0     # compaction merge work
    gc_lookups: int = 0         # GC validity lookups (paper 'lookup cost')
    gc_relocations: int = 0     # GC relocations (paper 'cleanup cost')
    compactions: int = 0
    # lifetime-aware placement (repro.core.lifetime; all zero when disabled)
    gc_short_lookups: int = 0   # lookup cost paid sweeping short-class logs
    gc_short_relocations: int = 0   # relocations out of short-class segments
    class_migrations: int = 0   # GC relocations that changed lifetime class
    cutoff_adaptations: int = 0  # adaptive t_ml cutovers applied


@dataclasses.dataclass
class StoreConfig:
    mode: str = "parallax"               # parallax | rocksdb | blobdb | nomerge
    t_sm: float = 0.20
    t_ml: float = 0.02
    l0_capacity: int = 1 << 20           # bytes of L0 before flush
    growth_factor: int = 8
    merge_depth: int = 1                 # mediums in place at the last k levels
    sorted_segments: bool = True         # eager L0 sorting of transient segments
    gc_threshold: float = 0.10           # parallax large-log GC trigger (§4)
    blobdb_scan_fraction: float = 0.30   # BlobDB GC scan fraction (§4)
    cache_bytes: int = 4 << 20
    auto_gc: bool = True                 # run GC after compactions (blobdb) / ticks
    blobdb_gc_every_flushes: int = 4     # GC wake frequency (scales the paper's
                                         # 'after a compaction' to our small L0)
    prefix_size: int = 12
    segment_bytes: int = 2 << 20         # log/level allocation granularity (§3.4)
    chunk_bytes: int = 256 << 10         # log append group-commit chunk (§3.4)
    bloom_bits_per_key: int = 0          # per-level bloom filters (0 = off, the
                                         # paper's index has none; ShardedStore
                                         # and bench_shard enable 10 bits/key)
    lifetime: LifetimeConfig | None = None   # lifetime-aware value placement
                                         # (parallax mode only): short/long
                                         # value logs + adaptive t_ml cutoff

    def policy(self) -> SizePolicy:
        return SizePolicy(t_sm=self.t_sm, t_ml=self.t_ml, prefix_size=self.prefix_size)


class ParallaxStore:
    def __init__(self, config: StoreConfig | None = None):
        self.config = config or StoreConfig()
        self.device = Device(
            cache_bytes=self.config.cache_bytes,
            segment_bytes=self.config.segment_bytes,
            chunk_bytes=self.config.chunk_bytes,
        )
        self.policy = self.config.policy()
        self.stats = StoreStats()
        self.lsn = 0
        self.l0: dict[bytes, IndexEntry] = {}
        self.l0_bytes = 0
        self.levels: list[Level] = []
        self.small_log = Log(self.device, "small")     # WAL for small+medium
        self.medium_log = TransientLog(self.device, "medium")
        self.large_log = Log(self.device, "large")
        # short-lived value log (lifetime-aware placement, HashKV-style class
        # grouping): allocation is lazy, so this is free when lifetime is off
        self.short_log = Log(self.device, "short", kind="short_log")
        self.compacted_lsn = 0                          # catalog high-water mark
        self._durable: dict[str, int] = {"small": 0, "medium": 0, "large": 0, "short": 0}
        # lifetime sketch + adaptive-cutoff state.  ``cutoff_autonomous``
        # stores apply their own proposals (bare store, hash shards:
        # adaptation is volatile and re-learned after a crash); the
        # range-sharded front-end flips it off and drains proposals through
        # its metadata WAL (record-then-apply) so cutovers replay on recovery.
        self.lifetime = (
            LifetimeSketch(self.config.lifetime)
            if self.config.lifetime is not None and self.config.mode == "parallax"
            else None
        )
        self.cutoff_autonomous = True
        self._cutoff_pending: tuple[float, float] | None = None
        # optional durability fence between GC's relocation flush and segment
        # reclaim (the range front-end journals reclaims through it so the
        # crash-point harness can enumerate the copy->reclaim window)
        self.gc_fence = None
        self._gc_region: dict[int, int] = {}            # seg offset -> dead bytes (info)
        self._in_gc = False                             # reentrancy guard
        # tombstone fence: while True, last-level compactions keep tombstones
        # instead of dropping them.  The range-sharded front-end pins the
        # destination of an in-flight migration: its tombstones are the only
        # evidence that a key was deleted after the ownership flip, and the
        # double-routing read path / copy-skip rule must keep seeing them
        # until the draining source is gone (like a sequence-number fence
        # pinning tombstone GC under a snapshot in a real LSM).
        self.pin_tombstones = False

    # ------------------------------------------------------------------ sizes
    def _classify(self, key: bytes, value: bytes) -> int:
        mode = self.config.mode
        if mode == "rocksdb":
            return CAT_SMALL
        if mode == "blobdb":
            return CAT_LARGE
        return int(self.policy.classify_scalar(len(key), len(value)))

    def num_levels(self) -> int:
        return len(self.levels)

    def _capacity(self, level_idx: int) -> int:
        return self.config.l0_capacity * self.config.growth_factor ** (level_idx + 1)

    def _in_place_zone(self, level_idx: int) -> bool:
        if self.config.mode in ("nomerge", "blobdb"):
            return False
        if self.config.mode == "rocksdb":
            return True
        return level_idx >= len(self.levels) - self.config.merge_depth

    # ------------------------------------------------------------------- puts
    def put(self, key: bytes, value: bytes) -> None:
        self._write(key, value, tombstone=False)

    def update(self, key: bytes, value: bytes) -> None:
        self.stats.updates += 1
        self._write(key, value, tombstone=False, counted=True)

    def delete(self, key: bytes) -> None:
        self.stats.deletes += 1
        self._write(key, b"", tombstone=True, counted=True)

    # contract: single-threaded
    def _write(self, key: bytes, value: bytes, *, tombstone: bool, counted: bool = False, internal: bool = False) -> None:
        if not internal:
            if not counted:
                self.stats.inserts += 1
            self.stats.app_bytes += len(key) + len(value)
        self.lsn += 1
        cat = CAT_SMALL if tombstone else self._classify(key, value)
        entry = IndexEntry(
            key=key, lsn=self.lsn, category=cat, tombstone=tombstone,
            kv_size=len(key) + len(value),
            slot_bytes=0 if self.config.mode == "rocksdb" else 4,
        )
        log_entry = LogEntry(self.lsn, key, value, cat, tombstone=tombstone)
        if cat == CAT_LARGE and not tombstone:
            # lifetime-aware class grouping: hot (short-lived) values go to
            # the aggressively-GC'd short log, everything else to the large
            # (long-lived) log.  Internal writes (GC relocation, migration)
            # re-classify with the *current* sketch — that is the class
            # migration path: a decayed key demotes to long on relocation.
            if self.lifetime is not None and self.lifetime.classify(key) == CLASS_SHORT:
                ptr = self.short_log.append(log_entry)
                entry.ptr, entry.log = ptr, "short"
            else:
                ptr = self.large_log.append(log_entry)
                entry.ptr, entry.log = ptr, "large"
        else:
            # small / medium / tombstone: WAL to Small log, value rides in L0
            self.small_log.append(log_entry)
            entry.value = value if not tombstone else None
        old = self.l0.get(key)
        if old is not None:
            self._mark_superseded(old)
            self.l0_bytes -= old.logical_size()
        self.l0[key] = entry
        self.l0_bytes += entry.logical_size()
        if self.lifetime is not None and not internal and not tombstone:
            # feed the sketch with application writes only — GC relocations
            # and migration copies are system work and must not look like
            # user updates (a relocated cold key is still cold)
            self.lifetime.observe(key, self.lsn)
            cfg = self.config.lifetime
            if cfg.adaptive and self.lsn % cfg.adapt_every == 0:
                self._propose_cutoffs()
        if self.l0_bytes >= self.config.l0_capacity:
            self.flush_l0()

    def _log_of(self, name: str | None) -> Log:
        if name == "large":
            return self.large_log
        if name == "short":
            return self.short_log
        return self.medium_log

    def _mark_superseded(self, entry: IndexEntry) -> None:
        if entry.ptr is None:
            return
        log = self._log_of(entry.log)
        log.mark_dead(entry.ptr)
        if entry.log in ("large", "short"):
            seg = log.segments.get(entry.ptr.segment_id)
            if seg is not None:
                # GC-region bookkeeping: free-space counter keyed by segment
                # start offset (16 B KV put into the private GC region, §3.2)
                self._gc_region[seg.offset] = seg.dead_bytes
                self.device.sequential_write(16, BLOCK, kind="log")

    # ------------------------------------------------------------ compactions
    def flush_l0(self) -> None:
        if not self.l0:
            return
        run = [self.l0[k] for k in sorted(self.l0)]
        max_lsn = max(e.lsn for e in run)
        self.l0.clear()
        self.l0_bytes = 0
        # the compacted level will reference log offsets, so logs must be
        # durable up to here (paper §3.4: the redo record logs the log offsets
        # covered by the L0->L1 compaction) — both value-log classes
        self.large_log.flush()
        self.short_log.flush()
        self._merge_into(0, run, from_l0=True, src_segments=[])
        self.compacted_lsn = max(self.compacted_lsn, max_lsn)
        # WAL reclaim: everything in the Small log is now durable in L1+
        self.small_log.flush()
        for seg in list(self.small_log.iter_segments()):
            self.small_log.reclaim(seg.segment_id)
        self._write_redo_record()
        self._cascade(0)
        self._flushes = getattr(self, "_flushes", 0) + 1
        if (
            self.config.mode == "blobdb"
            and self.config.auto_gc
            and self._flushes % self.config.blobdb_gc_every_flushes == 0
        ):
            self.gc_tick(force=True)

    def _cascade(self, start_idx: int) -> None:
        j = start_idx
        while j < len(self.levels):
            lvl = self.levels[j]
            if lvl.index_bytes <= self._capacity(j):
                j += 1
                continue
            run = lvl.entries
            src_segs = lvl.clear()
            # reading the upper level for the merge (direct I/O, §3.4)
            self.device.sequential_read(sum(e.index_size() for e in run), self.device.segment_bytes, kind="compaction")
            self._merge_into(j + 1, run, from_l0=False, src_segments=src_segs)
            self._write_redo_record()
            j += 1

    def _merge_into(self, dst_idx: int, run: list[IndexEntry], *, from_l0: bool, src_segments: list[int]) -> None:
        """Merge a sorted run (from L0 or level dst_idx-1) into levels[dst_idx]."""
        cfg = self.config
        while len(self.levels) <= dst_idx:
            self.levels.append(Level(len(self.levels), cfg.bloom_bits_per_key))
        dst = self.levels[dst_idx]
        self.stats.compactions += 1
        # read the lower (larger) level in full (paper Eq. 1 assumption / §3.4)
        self.device.sequential_read(dst.index_bytes, self.device.segment_bytes, kind="compaction")

        is_last = dst_idx == len(self.levels) - 1
        merged, dead = merge_runs(
            run, dst.entries, drop_tombstones=is_last and not self.pin_tombstones
        )
        self.stats.entries_merged += len(merged)
        for d in dead:
            self._mark_superseded(d)

        in_place = self._in_place_zone(dst_idx)
        pre_segment_ids = set(self.medium_log.segments.keys())
        new_segments: list[int] = []
        consumed_segments: set[int] = set()
        if in_place:
            # fetch every transient segment attached to src+dst exactly once
            for sid in {*src_segments, *dst.transient_segments}:
                if sid in self.medium_log.segments:
                    self.medium_log.merge_read(sid)
                    consumed_segments.add(sid)
        out: list[IndexEntry] = []
        for e in merged:
            if e.category == CAT_MEDIUM and not e.tombstone and cfg.mode in ("parallax", "nomerge"):
                if in_place:
                    if e.ptr is not None:
                        val = self.medium_log.get(e.ptr).value
                        e = dataclasses.replace(e, ptr=None, log=None, value=val)
                else:
                    if e.ptr is None:
                        # L0 medium: append (merge-sorted order) to transient log
                        ptr = self.medium_log.append(LogEntry(e.lsn, e.key, e.value or b"", CAT_MEDIUM))
                        e = dataclasses.replace(e, ptr=ptr, log="medium", value=None)
            out.append(e)
        # seal + attach transient segments produced by this merge
        self.medium_log.seal_tail(cfg.sorted_segments)
        if not in_place:
            survivors = [
                sid for sid in {*src_segments, *dst.transient_segments}
                if sid in self.medium_log.segments
            ]
            created = [
                sid for sid in self.medium_log.segments if sid not in pre_segment_ids
            ]
            new_segments = survivors + created
        else:
            for sid in consumed_segments:
                self.medium_log.reclaim(sid)
        dst.rebuild(out)
        dst.transient_segments = sorted(set(new_segments))
        # write the merged level (2 MB segment granularity direct I/O)
        self.device.sequential_write(dst.index_bytes, self.device.segment_bytes, kind="compaction")

    # contract: flush-before-record
    def _write_redo_record(self) -> None:
        # The redo record must not precede the data it covers (§3.4): mediums
        # the merge spilled to the transient log become durable first, else a
        # crash after the record would leave durable levels with dangling
        # medium pointers.
        self.medium_log.flush()
        # allocation/free lists + catalog entry (§3.4) — one small append
        self.device.sequential_write(512, BLOCK, kind="log")

    # ------------------------------------------------------------------- gets
    def _probe_level(self, lvl: Level, key: bytes, kind: str = "get") -> IndexEntry | None:
        if lvl.entries and not lvl.maybe_contains(key):
            self.stats.bloom_skips += 1
            return None
        self.stats.index_probes += 1
        if not lvl.entries:
            return None
        base = _LEVEL_REGION * (lvl.index + 1)
        # crc32, not hash(): the modeled cache block must be stable across
        # processes (PYTHONHASHSEED randomizes hash() for bytes)
        block = base + (zlib.crc32(key) % max(1, lvl.index_bytes)) // BLOCK * BLOCK
        self.device.random_read(block, 1, kind=kind)  # leaf block through cache
        return lvl.find(key)

    def _locate(self, key: bytes, *, kind: str = "get") -> IndexEntry | None:
        entry = self.l0.get(key)
        if entry is not None:
            return entry
        for lvl in self.levels:
            e = self._probe_level(lvl, key, kind=kind)
            if e is not None:
                return e
        return None

    # contract: single-threaded
    def get(self, key: bytes) -> bytes | None:
        self.stats.gets += 1
        entry = self._locate(key)
        if entry is None or entry.tombstone:
            return None
        self.stats.found += 1
        value = self._value_of(entry)
        self.stats.app_bytes += len(key) + len(value)
        return value

    def _value_of(self, entry: IndexEntry, kind: str = "get") -> bytes:
        if entry.in_place:
            return entry.value or b""
        return self._log_of(entry.log).read(entry.ptr, kind=kind).value

    # ------------------------------------------------------------------- scan
    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        """Merge per-level scanners (newest LSN wins), return up to count pairs."""
        return self._scan(start, None, count)

    def scan_range(self, start: bytes, end: bytes | None, *, internal: bool = False) -> list[tuple[bytes, bytes]]:
        """All live pairs with ``start <= key < end`` (``end=None`` = no bound).

        Same merged read path (and device charges) as :meth:`scan`; used by the
        range-sharded front-end to migrate a key range during a split/merge.
        ``internal=True`` marks it as system work (like GC lookups): the device
        pays, but application op/byte stats are untouched.
        """
        return self._scan(start, end, None, internal=internal)

    def _scan(self, start: bytes, end: bytes | None, count: int | None, *, internal: bool = False) -> list[tuple[bytes, bytes]]:
        limit = count if count is not None else (1 << 62)
        return list(itertools.islice(self.iter_range(start, end, internal=internal), limit))

    def iter_range(self, start: bytes, end: bytes | None = None, *,
                   internal: bool = False) -> Iterator[tuple[bytes, bytes]]:
        """Lazy sorted stream of live ``(key, value)`` pairs from ``start``.

        The merged read path behind :meth:`scan` / :meth:`scan_range` (both are
        ``islice`` over this): sources are snapshotted at the call (L0 sorted
        once, one cursor per level) and every device/app-byte charge is paid
        when the row is *yielded*, so consuming ``k`` rows costs exactly what
        ``scan(start, k)`` does — rows never pulled are never charged.  The
        stream is only valid while the store is not written to or compacted;
        interleaving writes with iteration is undefined (take a fresh iterator
        after mutating, like a RocksDB iterator without a snapshot pin).
        """
        if not internal:
            self.stats.scans += 1
        iters: list[Iterable[IndexEntry]] = []
        l0_items = [self.l0[k] for k in sorted(self.l0) if self.l0[k].key >= start]
        iters.append(iter(l0_items))
        for lvl in self.levels:
            iters.append(lvl.iter_from(start))
        heap: list[tuple[bytes, int, int, IndexEntry]] = []
        for src, it in enumerate(iters):
            e = next(it, None)
            if e is not None:
                heapq.heappush(heap, (e.key, -e.lsn, src, e))
        return self._merge_rows(iters, heap, end, internal)

    def _merge_rows(self, its: list[Iterable[IndexEntry]],
                    heap: list[tuple[bytes, int, int, IndexEntry]],
                    end: bytes | None, internal: bool) -> Iterator[tuple[bytes, bytes]]:
        last_key: bytes | None = None
        scanned_bytes = [0] * len(its)
        while heap:
            key, _, src, e = heapq.heappop(heap)
            if end is not None and key >= end:
                # sources are sorted, so this source is exhausted for the range
                continue
            nxt = next(its[src], None)
            if nxt is not None:
                heapq.heappush(heap, (nxt.key, -nxt.lsn, src, nxt))
            if key == last_key:
                continue
            last_key = key
            if e.tombstone:
                continue
            # leaf bytes stream sequentially per level; log values are random
            if src > 0:
                lvl = self.levels[src - 1]
                base = _LEVEL_REGION * lvl.index + scanned_bytes[src]
                self.device.random_read(base, e.index_size(), kind="get")
                scanned_bytes[src] += e.index_size()
            value = self._value_of(e)
            if not internal:
                self.stats.app_bytes += len(key) + len(value)
            yield (key, value)

    # ---------------------------------------------------------- ranged delete
    def newest_entries(self, start: bytes, end: bytes | None) -> dict[bytes, IndexEntry]:
        """Newest entry per key in ``[start, end)``, tombstones included.

        Pure index walk — no device traffic is charged (same discipline as
        :meth:`live_keys_in`, which is built on it).  The migration read path
        uses the tombstone visibility to decide which keys the new owner
        already answers for.
        """
        best: dict[bytes, IndexEntry] = {}
        sources: list[Iterable[IndexEntry]] = [
            iter([self.l0[k] for k in sorted(self.l0)])
        ]
        sources.extend(lvl.iter_from(start) for lvl in self.levels)
        for src in sources:
            for e in src:
                if e.key < start:
                    continue
                if end is not None and e.key >= end:
                    break
                cur = best.get(e.key)
                if cur is None or e.lsn > cur.lsn:
                    best[e.key] = e
        return best

    def index_entry(self, key: bytes) -> IndexEntry | None:
        """Newest entry for one key (tombstones included), pure index walk.

        No device traffic or stat accounting — the migration copy path uses
        it to skip keys the destination already holds a newer write for.
        """
        e = self.l0.get(key)
        if e is not None:
            return e
        for lvl in self.levels:
            found = lvl.find(key)
            if found is not None:
                return found
        return None

    def live_keys_in(self, start: bytes, end: bytes | None) -> list[bytes]:
        """Sorted live (non-tombstone, newest-LSN) keys in ``[start, end)``.

        Pure index walk — no device traffic is charged; callers that read the
        values pay through :meth:`scan_range`, callers that delete pay through
        the normal write path.
        """
        return sorted(
            k for k, e in self.newest_entries(start, end).items() if not e.tombstone
        )

    def delete_range(self, start: bytes, end: bytes | None, *, internal: bool = False,
                     keys: list[bytes] | None = None) -> int:
        """Tombstone every live key in ``[start, end)``; returns keys deleted.

        Each delete flows through the normal write path (WAL append, L0,
        flush/compaction), so a ranged delete obeys the same durability
        ordering as individual deletes — this is the migration hook the
        range-sharded front-end uses when a shard drops part of its range.
        ``internal=True`` marks the tombstones as system work (migration/GC
        style): charged to the device but not to application op/byte stats.
        A caller that already materialized the range (e.g. the scan side of a
        migration) passes ``keys`` to skip the index walk.
        """
        if keys is None:
            keys = self.live_keys_in(start, end)
        for k in keys:
            if internal:
                self._write(k, b"", tombstone=True, internal=True)
            else:
                self.delete(k)
        return len(keys)

    # ------------------------------------------------------ adaptive cutoffs
    def _propose_cutoffs(self) -> None:
        """Turn the sketch's distance ring into a t_ml cutover proposal.

        Autonomous stores (bare, hash shards) apply immediately — the adapted
        policy is volatile and re-learned after recovery.  Under a range
        front-end (``cutoff_autonomous=False``) the proposal parks in
        ``_cutoff_pending`` until the coordinator drains it through the
        shard-metadata WAL (record-then-apply) at a sequence point.
        """
        cfg = self.config.lifetime
        proposal = propose_cutoffs(
            self.config.policy(), self.lifetime.ring, cfg.window,
            min_ring=cfg.min_ring, max_shift=cfg.max_shift,
        )
        if proposal is None or proposal == (self.policy.t_sm, self.policy.t_ml):
            return
        if self.cutoff_autonomous:
            self.apply_cutoffs(*proposal)
        else:
            self._cutoff_pending = proposal

    def apply_cutoffs(self, t_sm: float, t_ml: float) -> None:
        """Install adapted size cutoffs (instance policy only — the shared
        ``StoreConfig`` stays the static anchor the controller reasons from)."""
        self.policy = dataclasses.replace(self.policy, t_sm=t_sm, t_ml=t_ml)
        self._cutoff_pending = None
        self.stats.cutoff_adaptations += 1

    def take_cutoff_proposal(self) -> tuple[float, float] | None:
        proposal, self._cutoff_pending = self._cutoff_pending, None
        return proposal

    def lifetime_state(self) -> dict | None:
        """Observability snapshot for the engine's ``lifetime`` stats namespace."""
        if self.lifetime is None:
            return None
        state = self.lifetime.state()
        state.update(
            t_sm=self.policy.t_sm,
            t_ml=self.policy.t_ml,
            short_log_segments=len(self.short_log.segments),
            long_log_segments=len(self.large_log.segments),
            short_log_bytes=self.short_log.total_bytes,
            long_log_bytes=self.large_log.total_bytes,
            class_migrations=self.stats.class_migrations,
            cutoff_adaptations=self.stats.cutoff_adaptations,
        )
        return state

    # --------------------------------------------------------------------- GC
    def gc_tick(self, force: bool = False) -> int:
        """Large-log GC (parallax, §3.2) or scan-fraction GC (blobdb).

        Returns the number of segments reclaimed.  With ``auto_gc=False`` the
        periodic ticks are disabled unless forced (the Fig. 1 no-GC variant).
        """
        cfg = self.config
        if cfg.mode in ("rocksdb", "nomerge") or self._in_gc:
            return 0
        if not cfg.auto_gc and not force:
            return 0
        # victims carry their owning log: with lifetime-aware placement the
        # short-lived class is swept aggressively (segments mostly dead by
        # the time they fill — relocation is nearly free) while the long
        # class rides to a much lazier threshold; without it, the single
        # large log uses the paper's static threshold
        victims: list[tuple[Log, object]] = []
        segs = [s for s in self.large_log.iter_segments() if s is not self.large_log._tail]
        if cfg.mode == "parallax":
            if self.lifetime is not None:
                lt = cfg.lifetime
                victims += [(self.large_log, s) for s in segs
                            if s.invalid_fraction() >= lt.long_gc_threshold]
                victims += [
                    (self.short_log, s)
                    for s in self.short_log.iter_segments()
                    if s is not self.short_log._tail
                    and s.invalid_fraction() >= lt.short_gc_threshold
                ]
            else:
                victims = [(self.large_log, s) for s in segs
                           if s.invalid_fraction() >= cfg.gc_threshold]
        else:  # blobdb: scan the oldest fraction of the log after compaction
            segs.sort(key=lambda s: s.segment_id)
            n = max(1, int(len(segs) * cfg.blobdb_scan_fraction)) if segs else 0
            victims = [(self.large_log, s) for s in segs[:n]]
        reclaimed = 0
        self._in_gc = True
        try:
            for log, seg in victims:
                short = log is self.short_log
                # (1) identify: scan the segment + one index lookup per KV
                self.device.sequential_read(seg.used_bytes, self.device.segment_bytes,
                                            kind="gc_short" if short else "gc")
                live: list[LogEntry] = []
                for slot, le in enumerate(seg.entries):
                    if le is None:
                        continue
                    self.stats.gc_lookups += 1
                    if short:
                        self.stats.gc_short_lookups += 1
                    cur = self._lookup_for_gc(le.key)
                    if (
                        cur is not None
                        and cur.ptr is not None
                        and cur.log == log.name
                        and cur.ptr.segment_id == seg.segment_id
                        and cur.ptr.slot == slot
                        and not cur.tombstone
                    ):
                        live.append(le)
                if cfg.mode == "blobdb" and seg.dead_bytes == 0:
                    # nothing to clean: identification cost only (paper Fig. 1 —
                    # pure-insert loads pay lookups but relocate nothing)
                    continue
                # (2) relocate: re-put valid pairs (paper: 'via a put operation').
                # The re-put reclassifies against the *current* sketch/policy,
                # so this is also the class-migration path (demotion of decayed
                # short keys, promotion of heated-up long keys).
                for le in live:
                    self.stats.gc_relocations += 1
                    if short:
                        self.stats.gc_short_relocations += 1
                    self._write(le.key, le.value, tombstone=False, internal=True)
                    if self.lifetime is not None:
                        moved = self.l0.get(le.key)
                        if moved is not None and moved.log != log.name:
                            self.stats.class_migrations += 1
                if live:
                    # durability barrier: relocations must be durable before
                    # the victim segment is freed, else a crash would expose
                    # the shadowed level entries whose pointers dangle into
                    # the reclaimed segment.  A relocation may land in any
                    # class log, so all of them flush.
                    self.small_log.flush()
                    self.large_log.flush()
                    self.short_log.flush()
                if self.gc_fence is not None:
                    # front-end fence between copy-durable and reclaim (the
                    # range store journals the reclaim here; a crash at the
                    # fence leaves both copies and recovery keeps newest-LSN)
                    self.gc_fence(log.name, seg.segment_id)
                log.reclaim(seg.segment_id)
                self._gc_region.pop(seg.offset, None)
                reclaimed += 1
        finally:
            self._in_gc = False
        return reclaimed

    def _lookup_for_gc(self, key: bytes) -> IndexEntry | None:
        e = self.l0.get(key)
        if e is not None:
            return e
        for lvl in self.levels:
            found = self._probe_level(lvl, key, kind="gc")
            if found is not None:
                return found
        return None

    # --------------------------------------------------------- crash/recovery
    def flush_all(self) -> None:
        self.small_log.flush()
        self.large_log.flush()
        self.short_log.flush()
        self.medium_log.flush()
        for log in (self.small_log, self.large_log, self.short_log, self.medium_log):
            if log.segments:
                mx = max(
                    (e.lsn for s in log.segments.values() for e in s.entries if e is not None),
                    default=0,
                )
                self._durable[log.name] = mx

    def crash(self) -> int:
        """Drop volatile state: L0 and any log entries past the last group commit.

        Returns the recovery cutoff LSN: the store recovers to the prefix of
        writes with ``lsn <= cutoff`` (paper §3.4: a previous — not necessarily
        the last — consistent point).  The cutoff is the largest LSN such that
        *every* write at or below it survives in some durable location, which
        with per-log group commit is ``min(first lost lsn per log) - 1``.
        """
        self.l0.clear()
        self.l0_bytes = 0
        first_lost = None
        for log in (self.small_log, self.large_log, self.short_log):
            cutoff = self._durable_lsn(log)
            for seg in log.iter_segments():
                for slot, e in enumerate(seg.entries):
                    if e is not None and e.lsn > cutoff:
                        if first_lost is None or e.lsn < first_lost:
                            first_lost = e.lsn
                        seg.entries[slot] = None
                        seg.live_bytes -= e.size
            log._unflushed = 0
        # The transient log is only ever referenced by compacted levels, and
        # the redo record flushes it first, so the durable prefix is exactly
        # the flushed bytes: drop the unflushed tail (it covers no level).
        med = self.medium_log
        durable_bytes = med.appended_bytes - med._unflushed
        for seg in med.iter_segments():
            for slot, e in enumerate(seg.entries):
                if e is not None and e.end_off > durable_bytes:
                    seg.entries[slot] = None
                    seg.live_bytes -= e.size
        med._unflushed = 0
        self._recovery_cutoff = (first_lost - 1) if first_lost is not None else self.lsn
        return self._recovery_cutoff

    def _durable_lsn(self, log: Log) -> int:
        """Entries beyond the last 256 KB chunk boundary are lost on crash."""
        durable_bytes = log.appended_bytes - log._unflushed
        last = 0
        for seg in log.segments.values():
            for e in seg.entries:
                if e is not None and e.end_off <= durable_bytes:
                    last = max(last, e.lsn)
        return max(last, self._durable.get(log.name, 0))

    def recover(self) -> None:
        """Replay Small + Large logs in LSN order to rebuild L0 (paper §3.4).

        Only LSNs up to the recovery cutoff are applied so the recovered state
        is a consistent prefix of the write history.
        """
        cutoff = getattr(self, "_recovery_cutoff", self.lsn)
        replay: list[tuple[int, LogEntry, tuple[str, Pointer] | None]] = []
        for seg in self.small_log.iter_segments():
            for e in seg.entries:
                if e is not None and self.compacted_lsn < e.lsn <= cutoff:
                    replay.append((e.lsn, e, None))
        for logname, vlog in (("large", self.large_log), ("short", self.short_log)):
            for seg in vlog.iter_segments():
                for slot, e in enumerate(seg.entries):
                    if e is not None and self.compacted_lsn < e.lsn <= cutoff:
                        replay.append((e.lsn, e, (logname, Pointer(seg.segment_id, slot))))
        replay.sort(key=lambda t: t[0])
        self.l0.clear()
        self.l0_bytes = 0
        for lsn, le, located in replay:
            self.device.random_read(lsn % (1 << 30), le.size, kind="get")
            entry = IndexEntry(
                key=le.key, lsn=lsn, category=le.category, tombstone=le.tombstone,
                kv_size=len(le.key) + len(le.value),
            )
            if located is not None:
                entry.log, entry.ptr = located
            elif not le.tombstone:
                entry.value = le.value
            old = self.l0.get(le.key)
            if old is not None:
                self.l0_bytes -= old.logical_size()
            self.l0[le.key] = entry
            self.l0_bytes += entry.logical_size()
            self.lsn = max(self.lsn, lsn)

    # ------------------------------------------------------------- snapshots
    def snapshot_rows(self) -> list[tuple[bytes, bytes, int, bool]]:
        """Newest row per key — ``(key, value, lsn, tombstone)``, sorted by key.

        The store's logical content for :meth:`load_rows`: tombstones and
        original LSNs are preserved because a migration destination's
        post-epoch tombstones (and the epoch fence itself) are part of the
        state a snapshot must carry.  Values resident in a log are read
        through the normal charged path (a backup pays to read its data);
        the index walk itself is free, like :meth:`newest_entries`.
        """
        rows: list[tuple[bytes, bytes, int, bool]] = []
        for key, e in sorted(self.newest_entries(b"", None).items()):
            value = b"" if e.tombstone else self._value_of(e)
            rows.append((key, value, e.lsn, e.tombstone))
        return rows

    def load_rows(self, rows: list[tuple[bytes, bytes, int, bool]], lsn: int = 0) -> None:
        """Load a :meth:`snapshot_rows` capture into this (fresh) store.

        Rows are written in ascending-LSN order and each write is pinned to
        its original LSN.  Ordering is load-bearing: a flush mid-load sets
        ``compacted_lsn`` to the run's max LSN, and :meth:`recover` skips
        entries at or below it — loading out of LSN order would silently
        drop rows after a later crash/recover.  Everything is flushed at the
        end, and the LSN counter lands at ``max(row lsns, lsn)`` so epoch
        fences and future writes behave exactly as in the source store.
        """
        for key, value, row_lsn, tombstone in sorted(rows, key=lambda r: r[2]):
            self.lsn = row_lsn - 1
            self._write(key, value, tombstone=tombstone, internal=True)
        self.flush_all()
        self.lsn = max(self.lsn, lsn)

    # ------------------------------------------------------------------ misc
    def amplification(self) -> float:
        app = max(1, self.stats.app_bytes)
        return self.device.stats.total / app

    def space_bytes(self) -> int:
        level_bytes = sum(l.index_bytes for l in self.levels)
        log_bytes = (self.small_log.total_bytes + self.medium_log.total_bytes
                     + self.large_log.total_bytes + self.short_log.total_bytes)
        return level_bytes + log_bytes

    def checkpoint_stats(self) -> dict:
        return {
            "amplification": self.amplification(),
            "device_read": self.device.stats.bytes_read,
            "device_written": self.device.stats.bytes_written,
            "levels": [len(l) for l in self.levels],
            "l0": len(self.l0),
            "medium_log_segments": len(self.medium_log.segments),
            "large_log_segments": len(self.large_log.segments),
            "short_log_segments": len(self.short_log.segments),
        }
