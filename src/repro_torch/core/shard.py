"""Sharded batch front-ends: N independent ParallaxStore shards behind one API.

First step from the single-store simulation toward a serving-scale system
(ROADMAP north star; Scavenger-style placement-aware sharding on top of the
paper's hybrid placement).  Two partitioning schemes share the plumbing here:

* :class:`ShardedStore` (this module) — **hash** partitioning with
  ``zlib.crc32`` routing: stable across processes, perfectly uniform load, but
  no key locality — every ``scan`` must consult all N shards and k-way merge.
* :class:`repro.core.range_shard.RangeShardedStore` — **range** partitioning:
  shards own contiguous key ranges, so a scan touches only the shards that
  overlap the range, at the cost of skew (hot ranges) which it repairs with
  load-driven splits/merges.

Pick hash when the workload is point-op dominated (YCSB A-D) and uniformity
matters more than scans; pick range when scans matter (YCSB E) or when the
shard map must adapt to hot-spots.

Each shard is a full :class:`~repro.core.store.ParallaxStore` with its own
:class:`~repro.core.io.Device`, LSM tree, logs and block cache — the model of
one store-per-core (or per-machine) deployment.  The shared base class
:class:`BaseShardedStore` adds:

* batched ``put_many`` / ``update_many`` / ``delete_many`` / ``get_many`` that
  group a batch by destination shard and drain each shard's sub-batch in one
  pass (order within a shard preserves batch order, so duplicate keys in one
  batch resolve to the last write like the sequential path);
* aggregated stats/amplification, and a parallel device-time model
  (``device_time`` = max over shards) used by the shard benchmarks to turn
  byte counts into a throughput proxy for N devices.

Crash/recover delegates to every shard.  Shard LSN counters are independent,
so ``crash()`` returns the per-shard recovery cutoffs — each shard recovers
to its own prefix; there is no single global LSN.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import zlib
from typing import Iterable, Iterator, Sequence

from .io import Device, DeviceStats, overlap_time
from .metalog import MetadataLog
from .store import ParallaxStore, StoreConfig, StoreStats

# routing uses a different crc32 stream than bloom/cache hashing so shard
# choice is uncorrelated with block placement inside a shard
_ROUTE_SEED = 0xA5A5A5A5


def route(key: bytes, num_shards: int) -> int:
    """Deterministic shard index for a key (crc32, stable across processes)."""
    return zlib.crc32(key, _ROUTE_SEED) % num_shards


def _next_key(key: bytes) -> bytes:
    """The smallest key strictly greater than ``key`` (cursor advance)."""
    return key + b"\x00"


@dataclasses.dataclass
class HashMigrationState:
    """One in-flight hash-rescale leg: the keys of slot ``src_id`` (under the
    old modulus) that route to slot ``dst_id`` under the new one.

    The moving set is hash-defined, not contiguous, so the leg carries both
    moduli and ``pending`` tests the routing predicate on top of the cursor:
    ``[b'', cursor)`` of the moving set is migrated (dst is sole owner),
    the rest is pending (dst owns writes, reads fall back to src on a miss).
    ``epoch_lsn`` is dst's LSN at the flip — dst entries above it postdate
    the flip and are authoritative, exactly like the range protocol.
    """

    src_id: int
    dst_id: int
    mod_old: int
    mod_new: int
    cursor: bytes
    epoch_lsn: int
    leg_index: int = 0      # position in the rescale's leg list (shrink legs
    kind: str = "hash"      # can share a dst, so ids alone don't name a leg)

    def moving(self, key: bytes) -> bool:
        return (route(key, self.mod_old) == self.src_id
                and route(key, self.mod_new) == self.dst_id)

    def covers(self, key: bytes) -> bool:
        return self.moving(key)

    def pending(self, key: bytes) -> bool:
        return key >= self.cursor and self.moving(key)


class BaseShardedStore:
    """Partitioning-agnostic sharded front-end: batching, stats, crash/recover.

    Subclasses provide the partitioning scheme by implementing
    :meth:`shard_of` (key -> shard index) and :meth:`scan` (global sorted
    scan); everything else — single ops, batched ops, GC, crash/recover and
    stat aggregation — routes through those and is shared.
    """

    # contract: coordinator-only
    def __init__(self, num_shards: int = 4, config: StoreConfig | None = None, *,
                 migration_batch_keys: int = 128, rescale_budget: int = 0):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        # the front-end is bloom-filtered by default (the bare store keeps the
        # paper's filterless index); an explicit config is taken as-is
        self.config = config or StoreConfig(bloom_bits_per_key=10)
        self.shards = [self._new_shard() for _ in range(num_shards)]
        # elastic rescale state, shared by both partitioning schemes: the
        # in-flight migration legs (each an ordinary journaled migration; the
        # range front-end also parks its single legacy split/merge leg here),
        # the rescale coordinator bookkeeping, and the per-tick knobs
        self.migration_batch_keys = migration_batch_keys
        self.rescale_budget = rescale_budget   # device bytes per tick; 0 = unthrottled
        self._migrations: list = []
        self._rescale = None                   # elastic.remap.RescaleState | None
        # shard-metadata WAL: the range front-end always journals; a hash
        # front-end creates it lazily at its first rescale (so a never-rescaled
        # hash fleet stays byte-identical to the pre-elastic accounting)
        self.meta_device: Device | None = None
        self.metalog: MetadataLog | None = None
        # front-end scan accounting: how many shards each scan had to consult
        # (the fan-out cost hash partitioning pays and range partitioning
        # avoids); survives topology changes, unlike per-shard counters
        self.scans = 0
        self.scan_probes = 0
        # front-end point-read accounting, same rationale: one probe per shard
        # consulted.  Normally get_probes == gets; during an incremental
        # migration a read that misses the new owner and falls back to the
        # draining old shard costs one extra probe (range front-end only).
        self.gets = 0
        self.get_probes = 0
        # stats of shards retired by topology changes (range-shard merges):
        # folded in here so aggregates never lose traffic history
        self.retired_stats = StoreStats()
        self.retired_device = DeviceStats()
        # Thread-safety (see docs/execution.md): shard stores are only ever
        # touched by one executor task at a time, but the *front-end* counters
        # above are shared.  The serial path is single-threaded and never
        # contends; `repro.core.exec.ShardExecutor` worker threads must hold
        # this lock for any front-end counter mutation (the double-routing
        # read path's fallback probes are the one in-worker site).
        self._stats_lock = threading.Lock()

    def _new_shard(self) -> ParallaxStore:
        return ParallaxStore(dataclasses.replace(self.config))

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def _all_stores(self) -> list[ParallaxStore]:
        """Every live backing store — the routed shards plus any store still
        draining out of the topology (a range-shard merge retires its source
        only once the migration finishes).  Maintenance, crash/recover and
        stat aggregation iterate this, not ``self.shards``."""
        return list(self.shards)

    @property
    def migrations(self) -> tuple:
        """Every in-flight migration leg (empty when the topology is stable).

        Legacy single split/merge migrations appear here as a one-leg tuple;
        a rescale parks one leg per moving shard pair.  The executor derives
        its merged queue groups from this."""
        return tuple(self._migrations)

    def rescale_progress(self) -> dict | None:
        """Progress counters of the in-flight rescale (None when idle)."""
        return None if self._rescale is None else self._rescale.progress()

    def _store_of_id(self, sid: int):
        """Backing store for a migration-leg shard id (range: registry id;
        hash: slot index, including a draining ex-slot)."""
        return self.shards[sid]

    # ---------------------------------------------------------------- routing
    def shard_of(self, key: bytes) -> int:
        raise NotImplementedError

    def shard_for(self, key: bytes) -> ParallaxStore:
        return self.shards[self.shard_of(key)]

    def _group(self, keys: Iterable[bytes]) -> dict[int, list[int]]:
        """Batch positions grouped by shard, preserving batch order per shard."""
        groups: dict[int, list[int]] = {}
        for pos, key in enumerate(keys):
            groups.setdefault(self.shard_of(key), []).append(pos)
        return groups

    # ------------------------------------------------------------- single ops
    def put(self, key: bytes, value: bytes) -> None:
        self.shard_for(key).put(key, value)

    def update(self, key: bytes, value: bytes) -> None:
        self.shard_for(key).update(key, value)

    def delete(self, key: bytes) -> None:
        self.shard_for(key).delete(key)

    def _get_from(self, sid: int, key: bytes) -> bytes | None:
        """Point-read routed to shard ``sid``; adaptive front-ends override
        this for migration-aware double-routing (and bump ``get_probes`` for
        any extra store they consult)."""
        return self.shards[sid].get(key)

    # contract: coordinator-only
    def get(self, key: bytes) -> bytes | None:
        self.gets += 1
        self.get_probes += 1
        return self._get_from(self.shard_of(key), key)

    # ------------------------------------------------------------ batched ops
    def _after_batch(self) -> None:
        """Hook run after every batched op (and GC tick): adaptive front-ends
        evaluate their policies here; the base class does nothing."""

    def put_many(self, items: Sequence[tuple[bytes, bytes]]) -> None:
        for sid, positions in self._group(k for k, _ in items).items():
            shard = self.shards[sid]
            for pos in positions:
                key, value = items[pos]
                shard.put(key, value)
        self._after_batch()

    def update_many(self, items: Sequence[tuple[bytes, bytes]]) -> None:
        for sid, positions in self._group(k for k, _ in items).items():
            shard = self.shards[sid]
            for pos in positions:
                key, value = items[pos]
                shard.update(key, value)
        self._after_batch()

    def delete_many(self, keys: Sequence[bytes]) -> None:
        for sid, positions in self._group(keys).items():
            shard = self.shards[sid]
            for pos in positions:
                shard.delete(keys[pos])
        self._after_batch()

    # contract: coordinator-only
    def get_many(self, keys: Sequence[bytes]) -> list[bytes | None]:
        out: list[bytes | None] = [None] * len(keys)
        for sid, positions in self._group(keys).items():
            for pos in positions:
                self.gets += 1
                self.get_probes += 1
                out[pos] = self._get_from(sid, keys[pos])
        self._after_batch()
        return out

    # ------------------------------------------------------------------- scan
    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        raise NotImplementedError

    def iter_rows(self, start: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        """Lazy global sorted row stream from ``start`` (no count bound).

        The cursor behind :class:`repro.api.Iterator`: rows are produced — and
        their device bytes charged — on demand, unlike :meth:`scan`, which
        materializes ``count`` rows per consulted shard up front.  Valid only
        while the store is not written to and the topology does not change;
        mutate, then take a fresh iterator.  Unlike ``scan``, iteration never
        runs the per-batch policy hook.
        """
        raise NotImplementedError

    # ------------------------------------------------------------ maintenance
    def gc_tick(self, force: bool = False) -> int:
        n = sum(s.gc_tick(force=force) for s in self._all_stores())
        self._after_batch()
        return n

    def flush_all(self) -> None:
        for s in self._all_stores():
            s.flush_all()

    def _fleet_bytes(self) -> int:
        """Total device bytes moved so far, fleet-wide (data + metadata WAL).
        The rescale budget meters the *delta* of this between sequence points."""
        total = sum(s.device.stats.total for s in self._all_stores())
        if self.meta_device is not None:
            total += self.meta_device.stats.total
        return total

    def _advance_leg(self, m, max_keys: int | None = None) -> int:
        raise NotImplementedError

    # contract: coordinator-only, record-then-apply
    def migration_tick(self, max_keys: int | None = None) -> int:
        """Advance the in-flight migration legs by one batch; returns keys moved.

        A legacy single-leg migration (range split/merge) advances exactly one
        batch per tick, as before.  Under a rescale the tick round-robins over
        the active legs and stops once the shared device-byte budget
        (``RescaleState.budget``) is spent — but always advances at least one
        leg, so even a tiny budget makes forward progress.  When the last leg
        drains, the tick appends the ``rescale_finish`` record and retires the
        coordinator state (roll-forward safe: a crash right at that record
        site resumes here on the next tick).
        """
        r = self._rescale
        if not self._migrations:
            if r is not None:
                self.metalog.append({"kind": "rescale_finish"})
                self._rescale = None
            return 0
        self.migration_ticks += 1
        if r is None:
            return self._advance_leg(self._migrations[0], max_keys)
        start_bytes = self._fleet_bytes()
        legs = list(self._migrations)
        moved = 0
        advanced = 0
        for i in range(len(legs)):
            if advanced and r.budget and self._fleet_bytes() - start_bytes >= r.budget:
                break
            leg = legs[(r.next_leg + i) % len(legs)]
            if leg in self._migrations:
                moved += self._advance_leg(leg, max_keys)
                advanced += 1
        r.next_leg = (r.next_leg + 1) % max(1, len(legs))
        r.ticks += 1
        r.keys_moved += moved
        if not self._migrations:
            self.metalog.append({"kind": "rescale_finish"})
            self._rescale = None
        return moved

    def drain_migration(self, max_ticks: int = 1_000_000) -> int:
        """Run :meth:`migration_tick` until every leg (and the rescale record
        stream, if one is open) is fully drained; returns ticks used."""
        n = 0
        while (self._migrations or self._rescale is not None) and n < max_ticks:
            self.migration_tick()
            n += 1
        return n

    def crash(self) -> list[int]:
        """Crash every live store; returns the per-store recovery cutoff LSNs.

        Store LSN counters are independent, so there is no single global
        cutoff — each store recovers to its own prefix (``_all_stores()[i]``
        honors the ``ParallaxStore.crash`` contract for cutoff ``[i]``).
        """
        return [s.crash() for s in self._all_stores()]

    def recover(self) -> None:
        for s in self._all_stores():
            s.recover()

    # -------------------------------------------------------------- snapshots
    def state_snapshot(self) -> dict:
        """Portable logical state: one row capture per shard, in shard order.

        Hash routing is positional, so the capture is meaningful only for a
        front-end with the *same* shard count — :meth:`load_state` enforces
        that.  Adaptive front-ends (range) override both methods with their
        topology-carrying form (including any in-flight migration; the hash
        form does not carry one, so snapshotting mid-rescale is refused).
        """
        if self._migrations:
            raise ValueError(
                "hash state snapshot with a rescale in flight is unsupported; "
                "drain the rescale first (drain_migration)")
        return {
            "kind": "hash",
            "shards": [{"rows": s.snapshot_rows(), "lsn": s.lsn} for s in self.shards],
        }

    def load_state(self, state: dict) -> None:
        """Replace every shard's contents with a :meth:`state_snapshot`."""
        if state.get("kind") != "hash":
            raise ValueError(f"expected a hash-store state, got {state.get('kind')!r}")
        snaps = state["shards"]
        if len(snaps) != len(self.shards):
            raise ValueError(
                f"state has {len(snaps)} shards, this front-end has {len(self.shards)}"
            )
        shards = []
        for snap in snaps:
            s = self._new_shard()
            s.load_rows(snap["rows"], snap["lsn"])
            shards.append(s)
        self.shards = shards

    # ------------------------------------------------------------------ stats
    def aggregate_stats(self) -> StoreStats:
        total = dataclasses.replace(self.retired_stats)
        for s in self._all_stores():
            for f in dataclasses.fields(StoreStats):
                setattr(total, f.name, getattr(total, f.name) + getattr(s.stats, f.name))
        return total

    def device_stats(self) -> DeviceStats:
        total = dataclasses.replace(self.retired_device)
        for s in self._all_stores():
            for f in dataclasses.fields(DeviceStats):
                setattr(total, f.name, getattr(total, f.name) + getattr(s.device.stats, f.name))
        return total

    def _retire_shard_stats(self, shard: ParallaxStore) -> None:
        """Fold a dropped shard's counters into the retired accumulators."""
        for f in dataclasses.fields(StoreStats):
            setattr(self.retired_stats, f.name,
                    getattr(self.retired_stats, f.name) + getattr(shard.stats, f.name))
        for f in dataclasses.fields(DeviceStats):
            setattr(self.retired_device, f.name,
                    getattr(self.retired_device, f.name) + getattr(shard.device.stats, f.name))

    def amplification(self) -> float:
        stats = self.aggregate_stats()
        return self.device_stats().total / max(1, stats.app_bytes)

    def device_times(self) -> list[float]:
        """Per-store device busy times (one entry per live backing store)."""
        return [s.device.device_time() for s in self._all_stores()]

    def device_time(self, policy: str = "ideal") -> float:
        """Completion time of the fleet's device traffic under an overlap
        policy (:func:`repro.core.io.overlap_time`): ``"ideal"`` — the default
        and the historical model — is perfect overlap (the slowest shard
        bounds the batch), ``"serial"`` is no overlap (sum), ``"channels:k"``
        packs shards onto k NVMe channels (LPT)."""
        return overlap_time(self.device_times(), policy)

    def space_bytes(self) -> int:
        return sum(s.space_bytes() for s in self._all_stores())

    def lifetime_states(self) -> list[dict] | None:
        """Per-shard lifetime/adaptive-cutoff observability (None when the
        config has no lifetime placement).  Hash shards adapt autonomously —
        each backing store applies its own cutoff proposals and re-learns
        them after recovery; the range front-end journals cutovers instead."""
        states = [s.lifetime_state() for s in self._all_stores()]
        if all(st is None for st in states):
            return None
        return states

    def checkpoint_stats(self) -> dict:
        return {
            "num_shards": self.num_shards,
            "amplification": self.amplification(),
            "per_shard": [s.checkpoint_stats() for s in self.shards],
        }


class ShardedStore(BaseShardedStore):
    """Hash-partitioned collection of ParallaxStores with batched APIs.

    Since the elastic-rescale work the fleet can also grow or shrink *online*
    between mod-routing-compatible sizes (:meth:`rescale`): each new/retiring
    slot becomes one journaled migration leg (``HashMigrationState``) with the
    same record-then-apply WAL discipline, double-routed reads and epoch-LSN
    fences as the range front-end's split/merge protocol.  The metadata WAL is
    created lazily at the first rescale, so a never-rescaled hash fleet is
    byte-identical to the pre-elastic accounting.
    """

    # contract: coordinator-only
    def __init__(self, num_shards: int = 4, config: StoreConfig | None = None, *,
                 migration_batch_keys: int = 128, rescale_budget: int = 0):
        super().__init__(num_shards, config,
                         migration_batch_keys=migration_batch_keys,
                         rescale_budget=rescale_budget)
        # double-routing read accounting (mirrors the range front-end): a read
        # that misses the new owner mid-rescale and falls back to the old slot
        self.get_fallbacks = 0
        self.migrated_keys = 0
        self.migration_ticks = 0
        # shrink: ex-slots past the new modulus keep serving their un-migrated
        # residue while their legs drain; retired (and stats-folded) at finish
        self._draining: dict[int, ParallaxStore] = {}

    # ---------------------------------------------------------------- routing
    def shard_of(self, key: bytes) -> int:
        return route(key, len(self.shards))

    def _all_stores(self) -> list[ParallaxStore]:
        return list(self.shards) + [self._draining[s] for s in sorted(self._draining)]

    def _store_of_id(self, sid: int) -> ParallaxStore:
        st = self._draining.get(sid)
        return st if st is not None else self.shards[sid]

    def _get_from(self, sid: int, key: bytes) -> bytes | None:
        """Double-routed point read during a rescale: the new owner ``sid`` is
        authoritative for entries newer than the leg's epoch LSN (and for the
        migrated prefix of the moving set); otherwise fall back to the old
        slot, charging the extra probe."""
        dst = self.shards[sid]
        for m in self._migrations:
            if m.dst_id == sid and m.pending(key):
                e = dst.index_entry(key)
                if e is not None and e.lsn > m.epoch_lsn:
                    break  # post-flip write on the new owner wins
                with self._stats_lock:
                    self.get_probes += 1
                    self.get_fallbacks += 1
                return self._store_of_id(m.src_id).get(key)
        return dst.get(key)

    # ------------------------------------------------------------------- scan
    def _scan_owner(self, key: bytes) -> ParallaxStore:
        """The store whose row for ``key`` is authoritative right now (the
        per-key arbiter behind the rescale-aware merged scan)."""
        slot = self.shard_of(key)
        dst = self.shards[slot]
        for m in self._migrations:
            if m.dst_id == slot and m.pending(key):
                e = dst.index_entry(key)
                if e is not None and e.lsn > m.epoch_lsn:
                    return dst
                return self._store_of_id(m.src_id)
        return dst

    # contract: coordinator-only
    def _iter_resolved(self, start: bytes) -> Iterator[tuple[bytes, bytes]]:
        """Merged row stream during a rescale: every live store (routed slots
        plus draining ex-slots) contributes, and each key is kept only from
        its authoritative owner — so a half-migrated key is never duplicated
        and a stale pre-flip copy never shadows a post-flip write."""
        stores = self._all_stores()
        self.scan_probes += len(stores)

        def tag(i: int, s: ParallaxStore):
            return ((k, i, v) for k, v in s.iter_range(start))

        tagged = [tag(i, s) for i, s in enumerate(stores)]
        for key, i, value in heapq.merge(*tagged):
            if self._scan_owner(key) is stores[i]:
                yield (key, value)

    # contract: coordinator-only
    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        """Global sorted scan: k-way merge of per-shard scans.

        Shards partition the keyspace by hash (not range), so every shard must
        be consulted for up to ``count`` pairs; the merge keeps the first
        ``count`` globally.  Keys are disjoint across shards — no dedup needed
        — except mid-rescale, when the merge also covers the draining ex-slots
        and each key is resolved against its authoritative owner.
        For a front-end whose scans touch only the shards overlapping the
        range, see :class:`repro.core.range_shard.RangeShardedStore`.
        """
        self.scans += 1
        if self._migrations:
            return list(itertools.islice(self._iter_resolved(start), count))
        self.scan_probes += len(self.shards)
        per_shard = [s.scan(start, count) for s in self.shards]
        return list(itertools.islice(heapq.merge(*per_shard), count))

    # contract: coordinator-only
    def iter_rows(self, start: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        """Incremental k-way merge of per-shard lazy streams.

        Every shard must still be consulted (hash routing has no key
        locality), but each contributes rows on demand: pulling ``k`` rows
        costs ~``k`` row reads plus one buffered lookahead row per shard,
        where the eager :meth:`scan` pays ``count`` rows on *every* shard.
        Mid-rescale the stream runs through the owner-resolved merge.
        """
        self.scans += 1
        if self._migrations:
            return self._iter_resolved(start)
        self.scan_probes += len(self.shards)
        return heapq.merge(*(s.iter_range(start) for s in self.shards))

    # ---------------------------------------------------------------- rescale
    def _ensure_metalog(self) -> None:
        if self.metalog is None:
            self.meta_device = Device(cache_bytes=0,
                                      segment_bytes=self.config.segment_bytes,
                                      chunk_bytes=self.config.chunk_bytes)
            self.metalog = MetadataLog(self.meta_device)

    # contract: coordinator-only, record-then-apply
    def rescale(self, new_shards: int, *, budget: int | None = None) -> int:
        """Start an online rescale to ``new_shards`` slots; returns the number
        of migration legs started (0 when ``new_shards`` equals the current
        count).

        Mod routing keeps movement minimal only between compatible sizes —
        ``new_shards`` must be a multiple (grow) or divisor (shrink) of the
        current count; anything else raises ``ValueError`` (a near-full
        reshuffle is never worth doing online).  The routing flip is applied
        only after the ``rescale_start`` record commits (record-then-apply);
        from then on every leg drains incrementally via
        :meth:`migration_tick`, with reads double-routed and writes going to
        the new owner.  ``budget`` (device bytes per tick, shared across all
        legs) defaults to the store's ``rescale_budget``; 0 = unthrottled.
        """
        from ..elastic.remap import RescaleState, Topology, plan_rescale

        if self._rescale is not None or self._migrations:
            raise ValueError(
                "a rescale is already in flight; drain it first (drain_migration)")
        n = len(self.shards)
        plan = plan_rescale(Topology("hash", n), new_shards)
        if not plan.legs:
            return 0
        self._ensure_metalog()
        if plan.new_shards > n:
            new_stores = [self._new_shard() for _ in range(n, plan.new_shards)]
            epochs = [s.lsn for s in new_stores]
        else:
            new_stores = []
            epochs = [self.shards[leg.dst].lsn for leg in plan.legs]
        legs_rec = [[leg.src, leg.dst, epochs[i]]
                    for i, leg in enumerate(plan.legs)]
        self.metalog.append({"kind": "rescale_start", "scheme": "hash",
                             "from": n, "to": plan.new_shards, "legs": legs_rec})
        # the flip: from here on shard_of routes under the new modulus
        if plan.new_shards > n:
            self.shards.extend(new_stores)
        else:
            for slot in range(plan.new_shards, n):
                self._draining[slot] = self.shards[slot]
            del self.shards[plan.new_shards:]
        for i, (src, dst, epoch) in enumerate(legs_rec):
            self.shards[dst].pin_tombstones = True
            self._migrations.append(HashMigrationState(
                src, dst, n, plan.new_shards, b"", epoch, leg_index=i))
        self._rescale = RescaleState(
            plan, budget=self.rescale_budget if budget is None else budget,
            dst_ids=tuple(leg.dst for leg in plan.legs))
        return len(plan.legs)

    # contract: coordinator-only, record-then-apply, flush-before-record
    def _advance_leg(self, m: HashMigrationState,
                     max_keys: int | None = None) -> int:
        """Move one batch of ``m``'s moving set from the old slot to the new
        owner: residue-sweep stale pre-flip rows on the destination, copy the
        batch (skipping keys the destination already rewrote post-flip), flush
        the destination, *then* journal the per-leg checkpoint, then delete
        the batch from the source — the crash-safe order."""
        budget = max(1, self.migration_batch_keys if max_keys is None else max_keys)
        src = self._store_of_id(m.src_id)
        dst = self.shards[m.dst_id]
        moving = [k for k in src.live_keys_in(m.cursor, None) if m.moving(k)]
        batch = moving[:budget]
        last_batch = len(moving) <= budget
        batch_hi = None if last_batch else _next_key(batch[-1])
        batch_set = set(batch)
        # residue sweep: pre-flip rows on the destination for keys of this
        # window's moving set with no authoritative replacement (what an
        # earlier crashed rescale left behind) get a post-flip tombstone
        for key, e in dst.newest_entries(m.cursor, batch_hi).items():
            if (e.lsn <= m.epoch_lsn and not e.tombstone and m.moving(key)
                    and key not in batch_set):
                dst._write(key, b"", tombstone=True, internal=True)
        moved = 0
        span_hi = batch_hi if batch_hi is not None else (
            _next_key(batch[-1]) if batch else m.cursor)
        if batch:
            for key, value in src.scan_range(batch[0], span_hi, internal=True):
                if key not in batch_set:
                    continue  # interleaved keys that are not moving
                cur = dst.index_entry(key)
                if cur is not None and cur.lsn > m.epoch_lsn:
                    continue  # rewritten on the new owner since the flip
                dst._write(key, value, tombstone=False, internal=True)
                moved += 1
        # durability barrier: the batch (and residue tombstones) must be
        # durable on the new owner before the record that advances ownership
        dst.flush_all()
        if batch:
            self.metalog.append({"kind": "checkpoint", "cursor": span_hi,
                                 "leg": m.leg_index})
            m.cursor = span_hi
            src.delete_range(batch[0], span_hi, internal=True, keys=batch)
            with self._stats_lock:
                self.migrated_keys += len(batch)
        if last_batch:
            # the finish record drops the leg from recovery's view, so every
            # src delete it covers must be durable first — a checkpoint-covered
            # delete may stay volatile (recovery's src residue sweep redoes it)
            src.flush_all()
            self.metalog.append({"kind": "finish", "leg": m.leg_index})
            self._finish_leg(m)
        return moved

    def _finish_leg(self, m: HashMigrationState) -> None:
        self._migrations.remove(m)
        if not any(x.dst_id == m.dst_id for x in self._migrations):
            self.shards[m.dst_id].pin_tombstones = False
        src = self._draining.pop(m.src_id, None)
        if src is not None:
            self._retire_shard_stats(src)
        if self._rescale is not None:
            self._rescale.legs_done += 1

    # ---------------------------------------------------------- crash/recover
    def recover(self) -> None:
        """Recover every store, then roll the metadata WAL forward (when one
        exists) to rebuild the in-flight rescale exactly as journaled."""
        for s in self._all_stores():
            s.recover()
        if self.metalog is not None:
            self._replay_metalog()

    def _replay_metalog(self) -> None:
        from ..elastic.remap import RescaleLeg, RescalePlan, RescaleState

        legs: list[HashMigrationState] = []
        start_rec: dict | None = None
        finished = True
        for rec in self.metalog.replay():
            kind = rec["kind"]
            if kind == "rescale_start":
                start_rec, finished = rec, False
                legs = [HashMigrationState(src, dst, rec["from"], rec["to"],
                                           b"", epoch, leg_index=i)
                        for i, (src, dst, epoch) in enumerate(rec["legs"])]
            elif kind == "checkpoint":
                for m in legs:
                    if m.leg_index == rec["leg"]:
                        m.cursor = rec["cursor"]
            elif kind == "finish":
                legs = [m for m in legs if m.leg_index != rec["leg"]]
            elif kind == "rescale_finish":
                legs, start_rec, finished = [], None, True
        self._migrations = legs
        for i, s in enumerate(self.shards):
            s.pin_tombstones = any(m.dst_id == i for m in legs)
        # src residue sweep: a checkpoint covers a durable dst copy, but the
        # matching src delete may have been volatile at the crash — re-delete
        # every moving key below each live leg's cursor (hash routing cannot
        # mask stale src rows the way range boundary routing does)
        for m in legs:
            src = self._store_of_id(m.src_id)
            residue = [k for k in src.live_keys_in(b"", m.cursor) if m.moving(k)]
            if residue:
                src.delete_range(residue[0], m.cursor, internal=True, keys=residue)
        # a shrink leg's finish may be durable while its _finish_leg never ran:
        # retire any draining ex-slot no live leg still sources
        live_srcs = {m.src_id for m in legs}
        for slot in [s for s in self._draining if s not in live_srcs]:
            self._retire_shard_stats(self._draining.pop(slot))
        if finished:
            self._rescale = None
            return
        # note: legs may be empty here with the rescale still open — a crash
        # exactly at the rescale_finish record site; the next migration_tick
        # re-appends it and retires the coordinator state
        n, to = start_rec["from"], start_rec["to"]
        frac = (to - n) / to if to > n else (n - to) / n
        plan = RescalePlan(
            "hash", n, to,
            tuple(RescaleLeg("hash", src, dst)
                  for src, dst, _ in start_rec["legs"]),
            None, frac)
        state = RescaleState(plan, budget=self.rescale_budget,
                             dst_ids=tuple(l.dst for l in plan.legs))
        state.legs_done = len(plan.legs) - len(legs)
        self._rescale = state

    # ------------------------------------------------------------------ stats
    def device_stats(self) -> DeviceStats:
        total = super().device_stats()
        if self.meta_device is not None:
            for f in dataclasses.fields(DeviceStats):
                setattr(total, f.name,
                        getattr(total, f.name) + getattr(self.meta_device.stats, f.name))
        return total

    def space_bytes(self) -> int:
        extra = self.metalog.log_bytes if self.metalog is not None else 0
        return super().space_bytes() + extra

    def device_time(self, policy: str = "ideal") -> float:
        extra = (self.meta_device.device_time()
                 if self.meta_device is not None else 0.0)
        return super().device_time(policy) + extra

    def checkpoint_stats(self) -> dict:
        out = super().checkpoint_stats()
        out["migrated_keys"] = self.migrated_keys
        out["migration_ticks"] = self.migration_ticks
        if self.metalog is not None:
            out["meta_records"] = self.metalog.n_records
            out["meta_bytes"] = self.metalog.bytes_appended
        if self._rescale is not None:
            out["rescale"] = self._rescale.progress()
        return out
