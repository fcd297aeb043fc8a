"""Range-partitioned sharding with incremental, WAL-backed rebalancing.

:class:`RangeShardedStore` partitions the keyspace into contiguous ranges —
shard ``i`` owns ``[boundaries[i], boundaries[i+1])`` with ``boundaries[0] ==
b""`` and the last range unbounded.  Point ops route by binary search over the
sorted boundary list; ``scan(start, count)`` touches **only the shards whose
range overlaps the scan** and concatenates their results (each shard's output
is already globally ordered — no k-way merge), which is what makes range
partitioning win scan workloads (YCSB E) where the hash-partitioned
:class:`~repro.core.shard.ShardedStore` must fan out to all N shards.

Two things changed from the PR 2 design (stop-the-world migration over an
in-memory atomic boundary map):

**Incremental migration.**  ``split()``/``merge()`` no longer copy their whole
range in one stall.  They install a :class:`MigrationState` and return; each
:meth:`migration_tick` (driven from batch boundaries — ``ycsb.execute``'s
batched ops land in ``_after_batch``) moves at most ``migration_batch_keys``
keys.  The boundary flips **at migration start**, with double-routing during
the transition:

* *writes* for the moved range go to the new owner immediately;
* *reads* probe the new owner first; only a true miss on a key in the
  **pending** region ``[cursor, hi)`` (not yet copied) falls back to the
  draining old shard (one extra probe, counted in ``get_probes``); keys below
  the cursor are the new owner's alone — its answer (including a tombstone)
  is authoritative, so stale copies in the old shard can never resurface;
* *scans* overlapping the pending region consult both sides and keep the old
  shard's row only when the new owner has no entry (live or tombstone) for
  that key.

Each tick preserves the flush-before-flip ordering *per batch*: copy the
batch into the new owner → flush the new owner's logs → write the migration
checkpoint record (this is the moment the batch's keys flip) → tombstone the
batch out of the old shard.  A copy never clobbers a newer write: any entry
the destination already holds with an LSN above the migration's start epoch
was written during the migration (an application write routed to the new
owner, or an earlier copy of the same key) and wins.

**Persistent shard-metadata WAL.**  Every boundary change, shard
create/retire and migration checkpoint is a durable
:class:`~repro.core.metalog.MetadataLog` record (``init`` / ``split_start`` /
``merge_start`` / ``checkpoint`` / ``finish`` / ``snapshot``), written
record-then-apply.  ``recover()`` replays the record stream from its oldest
retained record — genesis, or the ``snapshot`` record
:meth:`RangeShardedStore.snapshot_metadata` roots a truncated WAL at (PR 7) —
to rebuild the boundary
map, the live shard set and any in-flight :class:`MigrationState`, which then
resumes (rolls forward) on subsequent ticks — a crash at *any* record site
leaves a recoverable topology, which ``tests/test_crashpoints.py`` proves by
enumerating every site via ``MetadataLog.crash_after``.  Metadata bytes are
charged to a dedicated device with ``kind="meta"`` and folded into
``device_stats()``/``amplification()``.

Migration traffic is charged to the device like any other put/delete, but it
is *internal* work: like GC relocations, it does not count toward application
op/byte stats.
"""
from __future__ import annotations

import bisect
import dataclasses

from .io import Device, DeviceStats
from .metalog import MetadataLog
from .shard import BaseShardedStore
from .store import ParallaxStore, StoreConfig
from .ycsb import _warn_deprecated


def _uniform_boundaries(num_shards: int) -> list[bytes]:
    """Evenly spaced 2-byte prefixes over the full byte keyspace."""
    out = [b""]
    for i in range(1, num_shards):
        v = (1 << 16) * i // num_shards
        out.append(bytes([v >> 8, v & 0xFF]))
    return out


def _next_key(key: bytes) -> bytes:
    """The smallest key strictly greater than ``key`` (cursor advance)."""
    return key + b"\x00"


@dataclasses.dataclass
class MigrationState:
    """One in-flight range migration: ``[lo, hi)`` moving src -> dst.

    ``cursor`` splits the range: ``[lo, cursor)`` is *migrated* (dst is sole
    owner), ``[cursor, hi)`` is *pending* (dst owns writes, reads fall back
    to src on a miss).  ``epoch_lsn`` is dst's LSN when the migration began:
    any dst entry above it postdates the flip and must not be overwritten by
    a (re-)copy.
    """

    kind: str            # 'split' | 'merge'
    src_id: int
    dst_id: int
    lo: bytes
    hi: bytes | None     # None = unbounded (last shard)
    cursor: bytes
    epoch_lsn: int

    def covers(self, key: bytes) -> bool:
        return key >= self.lo and (self.hi is None or key < self.hi)

    def pending(self, key: bytes) -> bool:
        return key >= self.cursor and (self.hi is None or key < self.hi)


class RangeShardedStore(BaseShardedStore):
    """Contiguous key ranges over N ParallaxStores, rebalanced incrementally."""

    # contract: coordinator-only
    def __init__(
        self,
        num_shards: int = 4,
        config: StoreConfig | None = None,
        *,
        boundaries: list[bytes] | None = None,
        rebalance_window: int = 1024,
        split_factor: float = 2.0,
        merge_factor: float = 0.25,
        min_split_keys: int = 32,
        max_shards: int = 64,
        auto_rebalance: bool = True,
        migration_batch_keys: int = 128,
        rescale_budget: int = 0,
    ):
        if boundaries is not None:
            if not boundaries or boundaries[0] != b"":
                raise ValueError("boundaries must start with b'' (shard 0 owns the keyspace head)")
            if any(a >= b for a, b in zip(boundaries, boundaries[1:])):
                raise ValueError("boundaries must be strictly increasing")
            num_shards = len(boundaries)
        super().__init__(num_shards, config,
                         migration_batch_keys=migration_batch_keys,
                         rescale_budget=rescale_budget)
        self.boundaries = list(boundaries) if boundaries is not None else _uniform_boundaries(num_shards)
        self.rebalance_window = rebalance_window
        self.split_factor = split_factor
        self.merge_factor = merge_factor
        self.min_split_keys = min_split_keys
        self.max_shards = max_shards
        self.auto_rebalance = auto_rebalance
        self.splits = 0
        self.merges = 0
        self.migrated_keys = 0
        self.migration_ticks = 0
        self.get_fallbacks = 0  # pending-region reads served by the old shard
        # shard identity: the WAL names shards by id, not list position; the
        # registry holds every live store including a merge's draining source
        self._shard_ids = list(range(len(self.shards)))
        self._next_shard_id = len(self.shards)
        self._by_id: dict[int, ParallaxStore] = dict(zip(self._shard_ids, self.shards))
        # the shard-metadata WAL lives on its own (cache-less) device so its
        # bytes are attributable; device_stats() folds it into the aggregate
        self.meta_device = Device(
            cache_bytes=0,
            segment_bytes=self.config.segment_bytes,
            chunk_bytes=self.config.chunk_bytes,
        )
        self.metalog = MetadataLog(self.meta_device)
        self.metalog.append(
            {"kind": "init", "boundaries": list(self.boundaries), "shards": list(self._shard_ids)}
        )
        self._window_base = self._op_counts()

    @staticmethod
    def boundaries_for_keys(keys, num_shards: int) -> list[bytes]:
        """Balanced boundaries from a key sample (equal-population quantiles)."""
        ks = sorted(set(keys))
        bounds = [b""]
        for i in range(1, num_shards):
            b = ks[len(ks) * i // num_shards]
            if b > bounds[-1]:
                bounds.append(b)
        return bounds

    @classmethod
    def for_keys(cls, keys, num_shards: int, config: StoreConfig | None = None, **kw) -> "RangeShardedStore":
        """Pre-split on a key sample: see :meth:`boundaries_for_keys`."""
        return cls(config=config, boundaries=cls.boundaries_for_keys(keys, num_shards), **kw)

    # ---------------------------------------------------------------- routing
    def shard_of(self, key: bytes) -> int:
        return bisect.bisect_right(self.boundaries, key) - 1

    def bounds(self, i: int) -> tuple[bytes, bytes | None]:
        """Shard ``i``'s owned range ``[lo, hi)`` (``hi=None`` = unbounded)."""
        hi = self.boundaries[i + 1] if i + 1 < len(self.boundaries) else None
        return self.boundaries[i], hi

    @property
    def migration(self) -> MigrationState | None:
        """The single in-flight migration leg, or the first of a rescale's
        concurrent legs (compat view over ``self.migrations``)."""
        return self._migrations[0] if self._migrations else None

    def _leg_for_key(self, key: bytes) -> MigrationState | None:
        """The leg whose pending window holds ``key`` (legs' moved spans are
        disjoint, so at most one matches)."""
        for m in self._migrations:
            if m.pending(key):
                return m
        return None

    def _leg_for_dst(self, sid: int) -> MigrationState | None:
        """The leg migrating *into* shard id ``sid`` (range plans never give
        one destination two legs: split destinations are fresh shards, merge
        destinations are pairwise non-adjacent)."""
        for m in self._migrations:
            if m.dst_id == sid:
                return m
        return None

    def _store_of_id(self, sid: int) -> ParallaxStore:
        return self._by_id[sid]

    def _all_stores(self) -> list[ParallaxStore]:
        return list(self._by_id.values())

    def _new_shard(self) -> ParallaxStore:
        store = super()._new_shard()
        if store.lifetime is not None:
            # lifetime-aware shards under the range front-end journal their
            # adaptive-cutoff cutovers through the metadata WAL instead of
            # self-applying (record-then-apply; replayed on recovery), and
            # every value-log segment reclaim is fenced behind a WAL record
            # so the crash-point harness can enumerate the copy->reclaim
            # window of a class migration
            store.cutoff_autonomous = False
            store.gc_fence = (
                lambda log_name, segment_id, s=store:
                self._journal_gc_reclaim(s, log_name, segment_id)
            )
        return store

    def _register(self, store: ParallaxStore) -> int:
        sid = self._next_shard_id
        self._next_shard_id += 1
        self._by_id[sid] = store
        return sid

    # ------------------------------------------------------------- point read
    def _get_from(self, sid: int, key: bytes) -> bytes | None:
        """Double-routing read for a key in the pending region: the new owner
        answers authoritatively — even with a tombstone — iff its newest entry
        postdates the migration epoch (it was written after the ownership
        flip).  Anything older is pre-flip residue (a merge destination keeps
        stale tombstones from an earlier split's ranged delete in the absorbed
        range, and possibly stale live copies from a crashed one) and must
        defer to the draining old shard, costing one extra front-end probe.
        """
        m = self._leg_for_key(key)
        if m is not None:
            dst = self._by_id[m.dst_id]
            entry = dst.index_entry(key)  # pure index walk, free
            if entry is not None and entry.lsn > m.epoch_lsn:
                return dst.get(key)
            # the one front-end counter mutation that can run on an executor
            # worker thread (the migration pair's serialized queue): locked so
            # it never races the coordinator's batch-level counter bumps
            with self._stats_lock:
                self.get_probes += 1
                self.get_fallbacks += 1
            return self._by_id[m.src_id].get(key)
        return self.shards[sid].get(key)

    # ------------------------------------------------------------------- scan
    # contract: coordinator-only
    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        """Range-local scan: only shards overlapping ``[start, ...)`` are probed.

        Ranges are ordered and each shard's result is sorted, so concatenation
        is the global sorted order — no merge.  Results are clipped to each
        shard's owned range so stale copies left behind by a crashed migration
        (always at or past the shard's upper bound) can never surface.  While
        a migration is in flight, the migrating shard's rows are the merge of
        the new owner with the old shard's pending remainder (old rows only
        where the new owner holds no entry), costing one extra scan probe.
        """
        self.scans += 1
        out: list[tuple[bytes, bytes]] = []
        i = self.shard_of(start)
        while i < len(self.shards) and len(out) < count:
            self.scan_probes += 1
            lo, hi = self.bounds(i)
            for key, value in self._shard_rows(i, max(start, lo), count - len(out)):
                if hi is not None and key >= hi:
                    break
                out.append((key, value))
                if len(out) >= count:
                    break
            i += 1
        self._after_batch()  # scans feed the skew window like batched ops
        return out

    # contract: coordinator-only
    def iter_rows(self, start: bytes = b""):
        """Lazy range-local row stream: shards stream one at a time in
        boundary order (their output is already globally sorted), each pulled
        on demand, so rows never consumed are never read or charged.  A shard
        that is the destination of an in-flight migration is served through
        the eager merged view (:meth:`_shard_rows` — the double-routed
        resolution needs both sides' whole pending window); every other shard
        streams through :meth:`ParallaxStore.iter_range` clipped to its owned
        range.  Probe accounting matches ``scan``: one ``scan_probes`` per
        shard entered (plus the draining source, inside ``_shard_rows``) —
        shards the consumer never reaches are never probed.
        """
        self.scans += 1
        return self._iter_rows(start)

    # contract: coordinator-only
    def _iter_rows(self, start: bytes):
        i = self.shard_of(start)
        while i < len(self.shards):
            self.scan_probes += 1
            lo, hi = self.bounds(i)
            first = max(start, lo)
            if self._leg_for_dst(self._shard_ids[i]) is not None:
                for key, value in self._shard_rows(i, first, 1 << 62):
                    if hi is not None and key >= hi:
                        break
                    yield (key, value)
            else:
                # clipping at hi keeps stale post-bound residue from a crashed
                # migration invisible, exactly like scan's per-shard clip
                yield from self.shards[i].iter_range(first, hi)
            i += 1

    # contract: coordinator-only
    def _shard_rows(self, i: int, start: bytes, need: int) -> list[tuple[bytes, bytes]]:
        """Up to ``need`` sorted live rows of shard ``i`` from ``start``,
        merged with the draining source's pending remainder when shard ``i``
        is the destination of an in-flight migration.

        The merged view is resolved per key from index walks on both sides
        (free, like ``live_keys_in``), and only the rows actually returned
        pay a value read — the device cost of the extra probe the front-end
        counters report.  Resolution rule (the scan form of ``_get_from``):
        inside the pending window the owner's entry counts only when it
        postdates the flip — a post-flip tombstone keeps suppressing the
        stale source copy — while pre-flip residue (stale copies/tombstones
        from an earlier crashed split) defers to the draining source.
        Truncation is safe because both walks cover the *whole* window, so
        the first ``need`` resolved keys are the true merged prefix.
        """
        shard = self.shards[i]
        m = self._leg_for_dst(self._shard_ids[i])
        if m is None:
            return shard.scan(start, need)
        pend_lo = max(start, m.cursor)
        if m.hi is not None and pend_lo >= m.hi:
            return shard.scan(start, need)  # scan window is past the pending region
        shard.stats.scans += 1  # the owner serves the scan (skew signal)
        out: list[tuple[bytes, bytes]] = []
        if start < m.cursor:
            # the already-migrated prefix is the owner's alone; if it fills
            # the request the draining source is never consulted (or counted)
            own = shard.newest_entries(start, m.cursor)
            for k in sorted(own):
                e = own[k]
                if e.tombstone:
                    continue
                out.append((k, shard._value_of(e)))
                if len(out) >= need:
                    return out
        self.scan_probes += 1
        src = self._by_id[m.src_id]
        # key -> (answering store, its newest entry)
        resolved = {k: (src, e) for k, e in src.newest_entries(pend_lo, m.hi).items()}
        for k, e in shard.newest_entries(pend_lo, m.hi).items():
            if e.lsn <= m.epoch_lsn:
                continue  # pre-flip residue in the pending window
            resolved[k] = (shard, e)
        for k in sorted(resolved):
            owner, e = resolved[k]
            if e.tombstone:
                continue
            out.append((k, owner._value_of(e)))
            if len(out) >= need:
                break
        return out

    # ------------------------------------------------------------ batched ops
    # batch boundaries (BaseShardedStore's batched ops and gc_tick — which is
    # where ycsb.execute lands) are where migrations advance and, when no
    # migration is in flight, where the skew policy runs
    def _after_batch(self) -> None:
        self._drain_cutoff_proposals()
        if self._migrations or self._rescale is not None:
            self.migration_tick()
        elif self.auto_rebalance:
            self.rebalance_tick()

    # ----------------------------------------------- lifetime cutoff cutover
    def _sid_of(self, store: ParallaxStore) -> int:
        for sid, s in self._by_id.items():
            if s is store:
                return sid
        return -1  # unregistered (a split destination pre-record): still fenced

    # contract: flush-before-record
    def _journal_gc_reclaim(self, store: ParallaxStore, log_name: str, segment_id: int) -> None:
        """GC fence (installed on lifetime-enabled shards): the store calls
        this between making its relocations durable and reclaiming the victim
        segment.  The flush is the class-migration durability barrier —
        relocated values must never be covered by a record while they are
        volatile — and the record makes the reclaim a crash-enumerable site:
        a crash *at* the record leaves both copies, and recovery's newest-LSN
        replay keeps exactly one winner (zero lost, zero duplicated keys)."""
        store.flush_all()
        self.metalog.append(
            {"kind": "gc_reclaim", "shard": self._sid_of(store),
             "log": log_name, "segment": segment_id}
        )

    # contract: coordinator-only, record-then-apply
    def _apply_cutoffs(self, sid: int, t_sm: float, t_ml: float) -> None:
        """Durably journal an adaptive-cutoff cutover, then install it.

        Record-then-apply: a crash before the record means the cutover never
        happened (the store keeps proposing from its ring); a crash after it
        is replayed by recovery so the shard's placement policy is identical
        pre- and post-crash."""
        self.metalog.append({"kind": "cutoff", "shard": sid, "t_sm": t_sm, "t_ml": t_ml})
        self._by_id[sid].apply_cutoffs(t_sm, t_ml)

    def _drain_cutoff_proposals(self) -> None:
        """Runs at batch boundaries (sequence points): collect each shard's
        parked cutoff proposal and commit it through the WAL in shard-id
        order (deterministic record stream)."""
        for sid in sorted(self._by_id):
            proposal = self._by_id[sid].take_cutoff_proposal()
            if proposal is not None:
                self._apply_cutoffs(sid, *proposal)

    # ------------------------------------------------------------ rebalancing
    def _op_counts(self) -> list[int]:
        return [
            s.stats.inserts + s.stats.updates + s.stats.deletes + s.stats.gets + s.stats.scans
            for s in self.shards
        ]

    def rebalance_tick(self, force: bool = False) -> int:
        """Evaluate the skew policy over the current op window.

        Returns the number of topology changes *started* (0 or 1).  While a
        migration is in flight the policy is paused — the tick advances the
        migration instead, so at most one range is ever moving.  The window
        is the per-shard op-count delta since the last evaluation; nothing
        happens until ``rebalance_window`` ops accumulate (unless ``force``).
        A split of the hottest qualifying shard is preferred over a merge of
        the coldest qualifying adjacent pair.
        """
        if self._migrations or self._rescale is not None:
            self.migration_tick()
            return 0
        counts = self._op_counts()
        if len(counts) != len(self._window_base):
            # topology changed out-of-band (manual split/merge): restart window
            self._window_base = counts
            return 0
        deltas = [c - b for c, b in zip(counts, self._window_base)]
        total = sum(deltas)
        if (total < self.rebalance_window and not force) or total <= 0:
            return 0
        avg = total / len(self.shards)

        split_idx = None
        if len(self.shards) < self.max_shards:
            hot = max(range(len(deltas)), key=deltas.__getitem__)
            # >=: a shard carrying the whole window on a 2-shard map has
            # delta == split_factor * avg exactly and must still split; a
            # 1-shard map has no skew signal, so any full window qualifies
            if deltas[hot] >= self.split_factor * avg or len(self.shards) == 1:
                split_idx = hot
        merge_idx = None  # merge pair (merge_idx, merge_idx + 1)
        if len(self.shards) > 1:
            cold = min(range(len(self.shards) - 1), key=lambda i: deltas[i] + deltas[i + 1])
            if deltas[cold] + deltas[cold + 1] < self.merge_factor * avg:
                merge_idx = cold

        changed = 0
        if split_idx is not None and self._split(split_idx, background=True):
            changed = 1
        elif merge_idx is not None:
            self._merge(merge_idx, background=True)
            changed = 1
        self._window_base = self._op_counts()
        return changed

    # -------------------------------------------------------------- migration
    def split(self, i: int, at: bytes | None = None, *, background: bool = False) -> bool:
        """Deprecated public surface (warns once): ad-hoc topology mutation is
        engine-owned now — use ``repro.api`` ``Engine.rescale()`` for explicit
        shape changes (the auto-rebalance policy keeps handling skew).
        Delegates to the internal :meth:`_split` unchanged."""
        _warn_deprecated("RangeShardedStore.split", "repro.api Engine.rescale")
        return self._split(i, at, background=background)

    def merge(self, i: int, *, background: bool = False) -> None:
        """Deprecated public surface (warns once): see :meth:`split`.
        Delegates to the internal :meth:`_merge` unchanged."""
        _warn_deprecated("RangeShardedStore.merge", "repro.api Engine.rescale")
        self._merge(i, background=background)

    # contract: coordinator-only, record-then-apply
    def _split(self, i: int, at: bytes | None = None, *, background: bool = False) -> bool:
        """Split shard ``i`` at ``at`` (default: its median live key).

        Creates the new shard, durably records ``split_start`` and flips the
        boundary — from that instant writes in ``[at, hi)`` route to the new
        owner and reads double-route.  With ``background=True`` the key copy
        then proceeds one :meth:`migration_tick` batch at a time; otherwise
        the migration is drained before returning (the PR 2 stop-the-world
        behavior, as a special case).  Only one migration runs at a time: a
        still-active one is drained first.
        """
        self.drain_migration()
        src = self.shards[i]
        lo, hi = self.bounds(i)
        if at is None:
            keys = src.live_keys_in(lo, hi)
            if len(keys) < max(2, self.min_split_keys):
                return False
            at = keys[len(keys) // 2]
        if at <= lo or (hi is not None and at >= hi):
            return False
        dst = self._new_shard()
        dst_id = self._register(dst)
        src_id = self._shard_ids[i]
        # record-then-apply: if the record never lands (crash), the orphan
        # destination is dropped by recovery replay and the split never was
        self.metalog.append(
            {"kind": "split_start", "src": src_id, "dst": dst_id,
             "at": at, "hi": hi, "epoch": dst.lsn}
        )
        self.shards.insert(i + 1, dst)
        self._shard_ids.insert(i + 1, dst_id)
        self.boundaries.insert(i + 1, at)
        dst.pin_tombstones = True  # fence: see _finish_leg
        self._migrations.append(MigrationState("split", src_id, dst_id, at, hi, at, dst.lsn))
        self.splits += 1
        self._window_base = self._op_counts()
        if not background:
            self.drain_migration()
        return True

    # contract: coordinator-only, record-then-apply
    def _merge(self, i: int, *, background: bool = False) -> None:
        """Merge shard ``i+1`` into shard ``i`` (cold-neighbor compaction).

        Durably records ``merge_start`` and drops the boundary — the
        surviving shard owns the combined range immediately, the absorbed
        shard leaves the routed map but keeps draining through double-routed
        reads until its keys are migrated, then retires (stats folded).
        """
        self.drain_migration()
        left, right = self.shards[i], self.shards[i + 1]
        lo, hi = self.bounds(i + 1)
        # NOTE: the surviving shard may hold stale pre-flip entries in the
        # absorbed range (copies/tombstones a crashed earlier split left
        # behind).  They are *not* cleaned here — a one-shot clean would have
        # its own crash window — but swept per batch by migration_tick's
        # residue pass, and masked until then: reads and scans ignore
        # destination entries at or below the migration epoch.
        left_id, right_id = self._shard_ids[i], self._shard_ids[i + 1]
        self.metalog.append(
            {"kind": "merge_start", "src": right_id, "dst": left_id,
             "lo": lo, "hi": hi, "epoch": left.lsn}
        )
        del self.shards[i + 1]
        del self._shard_ids[i + 1]
        del self.boundaries[i + 1]
        left.pin_tombstones = True  # fence: see _finish_leg
        self._migrations.append(MigrationState("merge", right_id, left_id, lo, hi, lo, left.lsn))
        self.merges += 1
        self._window_base = self._op_counts()
        if not background:
            self.drain_migration()

    # contract: coordinator-only
    def rescale(self, new_shards: int, *, budget: int | None = None,
                key_sample=None) -> int:
        """Start an online rescale of the boundary map to ``new_shards``
        ranges; returns the number of migration legs started (0 when nothing
        changes).

        The plan comes from :func:`repro.elastic.remap.plan_rescale`:
        growing adds quantile cuts inside the most populous ranges (keys
        outside the cut spans never move), shrinking merges the lightest
        non-adjacent pairs; ``key_sample`` defaults to the fleet's live keys
        (an index walk — no device traffic).  Every leg is an ordinary
        journaled migration; all legs drain concurrently through
        :meth:`migration_tick` under a shared device-byte budget per tick
        (``budget``, default the store's ``rescale_budget``; 0 =
        unthrottled).  A rescale already in flight raises ``ValueError``; a
        legacy single split/merge leg is drained first, like ``_split`` does.
        """
        from ..elastic.remap import Topology, plan_rescale

        if self._rescale is not None:
            raise ValueError(
                "a rescale is already in flight; drain it first (drain_migration)")
        self.drain_migration()
        n = len(self.shards)
        if key_sample is None:
            key_sample = []
            for i, s in enumerate(self.shards):
                lo, hi = self.bounds(i)
                key_sample.extend(s.live_keys_in(lo, hi))
        plan = plan_rescale(Topology("range", n, tuple(self.boundaries)),
                            new_shards, key_sample=key_sample)
        if not plan.legs:
            return 0
        use_budget = self.rescale_budget if budget is None else budget
        if plan.new_shards > n:
            # split legs: fresh destination shards, one per boundary cut.
            # plan positions are post-rescale; old ids keep the positions of
            # their (surviving) boundaries, cut positions get the new ids
            dsts = [self._new_shard() for _ in plan.legs]
            dst_ids = [self._register(d) for d in dsts]
            ids_by_pos = {plan.boundaries.index(b): sid
                          for b, sid in zip(self.boundaries, self._shard_ids)}
            for leg, sid in zip(plan.legs, dst_ids):
                ids_by_pos[leg.dst] = sid
            new_ids = [ids_by_pos[p] for p in range(plan.new_shards)]
            legs_rec = [["split", ids_by_pos[leg.src], dst_ids[i],
                         leg.lo, leg.hi, dsts[i].lsn]
                        for i, leg in enumerate(plan.legs)]
        else:
            # merge legs: dropped position t drains into the surviving left
            # neighbor (non-adjacent drops guarantee t-1 survives)
            dropped = {leg.src for leg in plan.legs}
            new_ids = [sid for p, sid in enumerate(self._shard_ids)
                       if p not in dropped]
            legs_rec = [["merge", self._shard_ids[leg.src],
                         self._shard_ids[leg.src - 1], leg.lo, leg.hi,
                         self._by_id[self._shard_ids[leg.src - 1]].lsn]
                        for leg in plan.legs]
        return self._start_rescale(plan, legs_rec, new_ids, use_budget)

    # contract: coordinator-only, record-then-apply
    def _start_rescale(self, plan, legs_rec, new_ids, budget: int) -> int:
        """Commit the ``rescale_start`` record — the full post-rescale
        topology plus every leg — then flip the boundary map and install the
        legs.  Record-then-apply: a crash at the record site leaves the old
        topology; replay drops the orphan split destinations and the rescale
        never was."""
        from ..elastic.remap import RescaleState

        self.metalog.append(
            {"kind": "rescale_start", "scheme": "range",
             "boundaries": list(plan.boundaries), "shards": list(new_ids),
             "legs": [list(r) for r in legs_rec],
             "from": plan.old_shards, "to": plan.new_shards, "budget": budget})
        self.boundaries = list(plan.boundaries)
        self._shard_ids = list(new_ids)
        self.shards = [self._by_id[sid] for sid in new_ids]
        for kind, src_id, dst_id, lo, hi, epoch in legs_rec:
            self._by_id[dst_id].pin_tombstones = True  # fence: see _finish_leg
            self._migrations.append(
                MigrationState(kind, src_id, dst_id, lo, hi, lo, epoch))
        self._rescale = RescaleState(plan, budget=budget,
                                     dst_ids=tuple(r[2] for r in legs_rec))
        self._window_base = self._op_counts()
        return len(legs_rec)

    # contract: coordinator-only, record-then-apply, flush-before-record
    def _advance_leg(self, m: MigrationState, max_keys: int | None = None) -> int:
        """Advance one migration leg by one batch; returns keys copied.

        Per-batch ordering (the PR 1/PR 2 discipline at batch granularity):
        copy the batch into the destination → **flush the destination** →
        durably checkpoint the cursor (this record flips ownership of the
        batch) → tombstone the batch out of the source.  A crash anywhere
        re-runs the batch from the last durable cursor; re-copies are
        idempotent because any destination entry newer than the migration
        epoch (an application write since the flip, or the earlier copy
        itself) is left untouched.  Under a rescale the checkpoint/finish
        records carry a ``leg`` key (the destination shard id) so replay can
        advance the right one of several concurrent legs; legacy single-leg
        records are byte-identical to the pre-elastic stream.
        """
        budget = max(1, self.migration_batch_keys if max_keys is None else max_keys)
        src, dst = self._by_id[m.src_id], self._by_id[m.dst_id]
        keys = src.live_keys_in(m.cursor, m.hi)
        batch = keys[:budget]
        last_batch = len(keys) <= budget
        batch_hi = m.hi if last_batch else _next_key(batch[-1])
        # residue sweep: stale pre-flip entries in this tick's window (what a
        # crashed earlier split left in a merge destination) with no
        # authoritative replacement get a post-flip tombstone — the batch's
        # own copies shadow the rest.  Split destinations are fresh (epoch 0),
        # so this never fires for them.
        batch_set = set(batch)
        for key, e in dst.newest_entries(m.cursor, batch_hi).items():
            if e.lsn <= m.epoch_lsn and not e.tombstone and key not in batch_set:
                dst._write(key, b"", tombstone=True, internal=True)
        moved = 0
        if batch:
            for key, value in src.scan_range(batch[0], batch_hi, internal=True):
                cur = dst.index_entry(key)
                if cur is not None and cur.lsn > m.epoch_lsn:
                    continue  # written since the flip (app write or earlier copy)
                dst._write(key, value, tombstone=False, internal=True)
                moved += 1
        # durability barrier: the batch (and the residue tombstones) must be
        # durable in the new owner before the record that flips ownership
        dst.flush_all()
        if batch:
            new_cursor = batch_hi if batch_hi is not None else _next_key(batch[-1])
            rec = {"kind": "checkpoint", "cursor": new_cursor}
            if self._rescale is not None:
                rec["leg"] = m.dst_id  # names one of the concurrent legs
            self.metalog.append(rec)
            m.cursor = new_cursor
            # only now does the source drop the batch (tombstones through the
            # normal write path); losing them in a crash leaves stale copies
            # below the cursor — unreachable: reads and scans stop consulting
            # the source once a key's ownership has flipped
            src.delete_range(batch[0], batch_hi, internal=True, keys=batch)
            self.migrated_keys += len(batch)
        if last_batch:
            rec = {"kind": "finish"}
            if self._rescale is not None:
                rec["leg"] = m.dst_id
            self.metalog.append(rec)
            self._finish_leg(m)
        return moved

    def _finish_leg(self, m: MigrationState) -> None:
        # lift the tombstone fence: while the migration was in flight, the
        # destination's tombstones were the only evidence that a key was
        # deleted after the flip — compaction must not drop them at the last
        # level or the copy-skip rule / read fallback would resurrect the
        # source's stale copy.  With the source drained (and, for merges,
        # retired) they may be collected again.
        self._migrations.remove(m)
        if self._leg_for_dst(m.dst_id) is None:
            self._by_id[m.dst_id].pin_tombstones = False
        if m.kind == "merge":
            self._retire_by_id(m.src_id)
        if self._rescale is not None:
            self._rescale.legs_done += 1
        self._window_base = self._op_counts()

    def _retire_by_id(self, sid: int) -> None:
        """Drop a drained store from the registry, folding its history.

        Idempotent (recovery replay may retire a shard the live path already
        retired — or vice versa); folding happens exactly once, at the drop.
        """
        store = self._by_id.pop(sid, None)
        if store is not None:
            self._retire_shard_stats(store)

    # -------------------------------------------------------------- snapshots
    # contract: coordinator-only, flush-before-record, rename-before-truncate
    def snapshot_metadata(self, *, truncate: bool = True) -> int:
        """Append a ``snapshot`` record — the whole topology in one record —
        and (by default) truncate the WAL prefix it replaces.

        Ordering is rename-before-truncate: every shard store is flushed
        first (the data the record points at is durable before the record),
        the snapshot record commits synchronously, and only then is the
        now-redundant prefix destroyed.  A crash *at* the snapshot's record
        site therefore leaves the full old stream — recovery replays from
        genesis exactly as before — while a crash any time after it replays
        O(delta): the snapshot record plus whatever followed it.  Returns the
        snapshot record's index (0 after truncation).
        """
        for store in self._all_stores():
            store.flush_all()
        m = self.migration if self._rescale is None else None
        rec = {
            "kind": "snapshot",
            "boundaries": list(self.boundaries),
            "shards": list(self._shard_ids),
            "next_shard_id": self._next_shard_id,
            "migration": None if m is None else dataclasses.asdict(m),
            # adapted per-shard cutoffs ride the snapshot so truncating
            # the WAL prefix doesn't forget journaled cutoff cutovers
            "cutoffs": [
                [sid, store.policy.t_sm, store.policy.t_ml]
                for sid, store in sorted(self._by_id.items())
                if store.lifetime is not None
            ],
        }
        if self._rescale is not None:
            # an in-flight rescale rides the snapshot (key absent otherwise,
            # so legacy snapshot records stay byte-identical): the active
            # legs at their cursors plus the coordinator bookkeeping
            rec["rescale"] = self._rescale_record()
        idx = self.metalog.append(rec)
        if truncate:
            self.metalog.truncate(idx)
            idx = 0
        return idx

    def state_snapshot(self) -> dict:
        """Portable logical state: topology + per-store rows (by shard id).

        Includes the draining source of an in-flight migration and the full
        :class:`MigrationState`, so a restore resumes the migration exactly
        where the snapshot caught it — likewise a whole in-flight rescale
        (every concurrent leg plus the coordinator bookkeeping, under the
        ``"rescale"`` key).  Used by ``repro.api.Engine.snapshot`` /
        ``clone``; the inverse is :meth:`load_state`.
        """
        m = self.migration if self._rescale is None else None
        state = {
            "kind": "range",
            "boundaries": list(self.boundaries),
            "shard_ids": list(self._shard_ids),
            "next_shard_id": self._next_shard_id,
            "migration": None if m is None else dataclasses.asdict(m),
            "stores": [
                [sid, {"rows": store.snapshot_rows(), "lsn": store.lsn}]
                for sid, store in sorted(self._by_id.items())
            ],
        }
        if self._rescale is not None:
            state["rescale"] = self._rescale_record()
        return state

    def _rescale_record(self) -> dict:
        """Portable form of the in-flight rescale: the active legs at their
        cursors plus everything needed to rebuild the plan and coordinator
        (``RescalePlan``/``RescaleState``) on replay or restore."""
        r = self._rescale
        return {
            "legs": [dataclasses.asdict(m) for m in self._migrations],
            "plan_legs": [[l.kind, l.src, l.dst] for l in r.plan.legs],
            "from": r.plan.old_shards,
            "to": r.plan.new_shards,
            "moved_fraction": r.plan.moved_fraction,
            "budget": r.budget,
            "dst_ids": list(r.dst_ids),
            "keys_moved": r.keys_moved,
            "ticks": r.ticks,
            "next_leg": r.next_leg,
        }

    def _load_rescale(self, rec: dict, boundaries) -> None:
        """Inverse of :meth:`_rescale_record`: install legs + coordinator."""
        from ..elastic.remap import RescaleLeg, RescalePlan, RescaleState

        self._migrations = [MigrationState(**d) for d in rec["legs"]]
        plan = RescalePlan(
            "range", rec["from"], rec["to"],
            tuple(RescaleLeg(k, s, d) for k, s, d in rec["plan_legs"]),
            tuple(boundaries), rec["moved_fraction"])
        state = RescaleState(plan, budget=rec["budget"],
                             dst_ids=tuple(rec["dst_ids"]))
        state.legs_done = len(plan.legs) - len(self._migrations)
        state.keys_moved = rec["keys_moved"]
        state.ticks = rec["ticks"]
        state.next_leg = rec["next_leg"]
        self._rescale = state

    def load_state(self, state: dict) -> None:
        """Replace this store's contents with a :meth:`state_snapshot`.

        Builds fresh shard stores (tombstone fences installed *before* rows
        load, so a migration destination's post-epoch tombstones survive
        compaction during the load), installs the topology and in-flight
        migration, and roots the metadata WAL at a fresh truncated snapshot
        record — the restored store recovers without the donor's history.
        """
        if state.get("kind") != "range":
            raise ValueError(f"expected a range-store state, got {state.get('kind')!r}")
        rescale = state.get("rescale")
        if rescale is not None:
            migrations = [MigrationState(**d) for d in rescale["legs"]]
        else:
            m = state["migration"]
            migrations = [] if m is None else [MigrationState(**m)]
        pinned = {m.dst_id for m in migrations}
        by_id: dict[int, ParallaxStore] = {}
        for sid, snap in state["stores"]:
            store = self._new_shard()
            store.pin_tombstones = sid in pinned
            store.load_rows(snap["rows"], snap["lsn"])
            by_id[sid] = store
        self.boundaries = list(state["boundaries"])
        self._shard_ids = list(state["shard_ids"])
        self._by_id = by_id
        self.shards = [by_id[sid] for sid in self._shard_ids]
        if rescale is not None:
            self._load_rescale(rescale, state["boundaries"])
        else:
            self._migrations = migrations
            self._rescale = None
        self._next_shard_id = max(state["next_shard_id"], max(by_id, default=-1) + 1)
        self.snapshot_metadata(truncate=True)
        self._window_base = self._op_counts()

    # --------------------------------------------------------------- recovery
    def recover(self) -> None:
        """Rebuild topology + in-flight migration from the metadata WAL, then
        recover every live store.

        The WAL — not the possibly-mid-mutation in-memory maps — is the source
        of truth: replay reconstructs ``boundaries``/``shards`` from the
        ``init`` record forward, restores the :class:`MigrationState` of an
        unfinished migration at its last durable checkpoint (it resumes on
        subsequent ticks), and drops orphan stores whose start record never
        landed.  Shard *objects* are looked up by id in the registry: their
        contents are the (simulated) device's contents, which survive the
        crash just like a single ``ParallaxStore``'s do.
        """
        self._replay_metalog()
        for s in self._all_stores():
            s.recover()

    def _replay_metalog(self) -> None:
        from ..elastic.remap import RescaleLeg, RescalePlan, RescaleState

        boundaries: list[bytes] = []
        ids: list[int] = []
        migrations: list[MigrationState] = []
        rescale_state: RescaleState | None = None
        snap_next = 0
        cutoffs: dict[int, tuple[float, float]] = {}
        for rec in self.metalog.replay():
            kind = rec["kind"]
            if kind == "init":
                boundaries = list(rec["boundaries"])
                ids = list(rec["shards"])
            elif kind == "snapshot":
                # a full-state reset mid-stream: after truncation this is
                # records[0] and replay proceeds from here instead of genesis
                boundaries = list(rec["boundaries"])
                ids = list(rec["shards"])
                m = rec["migration"]
                migrations = [] if m is None else [MigrationState(**m)]
                r = rec.get("rescale")
                if r is not None:
                    migrations = [MigrationState(**d) for d in r["legs"]]
                    plan = RescalePlan(
                        "range", r["from"], r["to"],
                        tuple(RescaleLeg(k, s, d) for k, s, d in r["plan_legs"]),
                        tuple(boundaries), r["moved_fraction"])
                    rescale_state = RescaleState(
                        plan, budget=r["budget"], dst_ids=tuple(r["dst_ids"]))
                    rescale_state.legs_done = len(plan.legs) - len(migrations)
                    rescale_state.keys_moved = r["keys_moved"]
                    rescale_state.ticks = r["ticks"]
                    rescale_state.next_leg = r["next_leg"]
                else:
                    rescale_state = None
                snap_next = max(snap_next, rec["next_shard_id"])
                for sid, t_sm, t_ml in rec.get("cutoffs", ()):
                    cutoffs[sid] = (t_sm, t_ml)
            elif kind == "cutoff":
                # journaled adaptive-cutoff cutover: last record wins per shard
                cutoffs[rec["shard"]] = (rec["t_sm"], rec["t_ml"])
            elif kind == "gc_reclaim":
                # GC reclaim fence: purely a crash-enumerable sequence point —
                # the relocations it covers are replayed from the value logs
                pass
            elif kind == "split_start":
                pos = ids.index(rec["src"])
                boundaries.insert(pos + 1, rec["at"])
                ids.insert(pos + 1, rec["dst"])
                migrations = [MigrationState(
                    "split", rec["src"], rec["dst"], rec["at"], rec["hi"], rec["at"], rec["epoch"]
                )]
            elif kind == "merge_start":
                pos = ids.index(rec["src"])
                del boundaries[pos]
                del ids[pos]
                migrations = [MigrationState(
                    "merge", rec["src"], rec["dst"], rec["lo"], rec["hi"], rec["lo"], rec["epoch"]
                )]
            elif kind == "rescale_start":
                # the whole flip in one record: topology after, one leg per
                # moving pair (all start at their span's lo)
                boundaries = list(rec["boundaries"])
                ids = list(rec["shards"])
                migrations = [
                    MigrationState(k, src, dst, lo, hi, lo, epoch)
                    for k, src, dst, lo, hi, epoch in rec["legs"]]
                plan = RescalePlan(
                    "range", rec["from"], rec["to"],
                    tuple(RescaleLeg(k, s, d)
                          for k, s, d, _lo, _hi, _e in rec["legs"]),
                    tuple(boundaries), 0.0)
                rescale_state = RescaleState(
                    plan, budget=rec["budget"],
                    dst_ids=tuple(r[2] for r in rec["legs"]))
            elif kind == "checkpoint":
                m = (migrations[0] if "leg" not in rec else
                     next(x for x in migrations if x.dst_id == rec["leg"]))
                m.cursor = rec["cursor"]
            elif kind == "finish":
                m = (migrations[0] if "leg" not in rec else
                     next(x for x in migrations if x.dst_id == rec["leg"]))
                if m.kind == "merge":
                    self._retire_by_id(m.src_id)
                migrations.remove(m)
                if rescale_state is not None:
                    rescale_state.legs_done += 1
            elif kind == "rescale_finish":
                migrations = []
                rescale_state = None
        live = set(ids)
        for m in migrations:
            live.update((m.src_id, m.dst_id))
        for sid in [s for s in self._by_id if s not in live]:
            # a destination created just before its start record was lost:
            # empty by construction (data only moves after the record), drop
            del self._by_id[sid]
        self.boundaries = boundaries
        self._shard_ids = ids
        self.shards = [self._by_id[sid] for sid in ids]
        self._migrations = migrations
        self._rescale = rescale_state
        # rebuild the tombstone fence from the WAL (it is derived state): only
        # the destinations of in-flight migration legs, if any, are pinned
        pinned = {m.dst_id for m in migrations}
        for sid, store in self._by_id.items():
            store.pin_tombstones = sid in pinned
            applied = cutoffs.get(sid)
            if applied is not None and store.lifetime is not None:
                store.apply_cutoffs(*applied)
        self._next_shard_id = max(self._next_shard_id, snap_next, max(live, default=0) + 1)
        self._window_base = self._op_counts()

    # ------------------------------------------------------------------ stats
    def device_stats(self) -> DeviceStats:
        total = super().device_stats()
        for f in dataclasses.fields(DeviceStats):
            setattr(total, f.name, getattr(total, f.name) + getattr(self.meta_device.stats, f.name))
        return total

    def space_bytes(self) -> int:
        # retained WAL bytes, not lifetime-appended: truncation reclaims space
        return super().space_bytes() + self.metalog.log_bytes

    def device_time(self, policy: str = "ideal") -> float:
        """Shard devices combined under the overlap policy, plus the metadata
        WAL's serial commits — synchronous records block the protocol, they
        never overlap shard traffic regardless of policy."""
        return super().device_time(policy) + self.meta_device.device_time()

    def checkpoint_stats(self) -> dict:
        out = super().checkpoint_stats()
        m = self.migration if self._rescale is None else None
        out.update(
            boundaries=list(self.boundaries),
            splits=self.splits,
            merges=self.merges,
            migrated_keys=self.migrated_keys,
            migration_ticks=self.migration_ticks,
            get_fallbacks=self.get_fallbacks,
            migration=None if m is None else dataclasses.asdict(m),
            meta_records=self.metalog.n_records,
            meta_bytes=self.metalog.bytes_appended,
        )
        if self._rescale is not None:
            out["rescale"] = self._rescale.progress()
        return out


__all__ = ["MigrationState", "RangeShardedStore"]
