"""Value logs: Small (WAL), Large (GC'd), and Medium transient logs.

Logs are lists of 2 MB segments (paper §3.4).  Appends buffer into a circular
tail buffer and hit the device in 256 KB chunks.  Entries are addressed by
``(segment_id, slot)`` pointers; the device offset of a segment comes from the
shared allocator so GC-region bookkeeping can be keyed by segment start offset
(paper §3.2).

The Medium log is *transient* (paper §3.3): its segments are attached to an
LSM level and travel down with compactions; when they reach the merge level
their contents are merged in place and the segments are reclaimed wholesale —
no GC walk ever happens on the medium log.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

from .io import CHUNK, SEGMENT, Device


@dataclasses.dataclass
class LogEntry:
    lsn: int
    key: bytes
    value: bytes
    category: int  # 0 small, 1 medium, 2 large
    tombstone: bool = False
    end_off: int = 0  # cumulative append offset; durable iff <= flushed bytes

    @property
    def size(self) -> int:
        # 8B LSN + 4B sizes header + payload (tombstones carry no value)
        return 12 + len(self.key) + (0 if self.tombstone else len(self.value))


@dataclasses.dataclass
class Pointer:
    """Device-side address of a log entry: segment id + slot inside it."""

    segment_id: int
    slot: int


class Segment:
    __slots__ = ("segment_id", "offset", "entries", "live_bytes", "dead_bytes", "sorted")

    def __init__(self, segment_id: int, offset: int):
        self.segment_id = segment_id
        self.offset = offset
        self.entries: list[LogEntry | None] = []
        self.live_bytes = 0
        self.dead_bytes = 0
        self.sorted = False

    @property
    def used_bytes(self) -> int:
        return self.live_bytes + self.dead_bytes

    def invalid_fraction(self) -> float:
        used = self.used_bytes
        return (self.dead_bytes / used) if used else 0.0


class Log:
    """Append-only segmented log with chunked device writes."""

    def __init__(self, device: Device, name: str, kind: str = "log"):
        self.device = device
        self.name = name
        self.kind = kind  # device-stat attribution ('log' for value logs,
        #                   'meta' for the shard-metadata WAL)
        self.segments: dict[int, Segment] = {}
        self._next_segment_id = 0
        self._tail: Segment | None = None
        self._unflushed = 0  # bytes buffered in the tail chunk
        self.appended_bytes = 0

    # -- append path ----------------------------------------------------------
    def _new_segment(self) -> Segment:
        seg = Segment(self._next_segment_id, self.device.alloc_segment())
        self._next_segment_id += 1
        self.segments[seg.segment_id] = seg
        return seg

    # contract: single-threaded
    def append(self, entry: LogEntry) -> Pointer:
        if self._tail is None or self._tail.used_bytes + entry.size > self.device.segment_bytes:
            self.flush()
            self._tail = self._new_segment()
        seg = self._tail
        seg.entries.append(entry)
        seg.live_bytes += entry.size
        self.appended_bytes += entry.size
        entry.end_off = self.appended_bytes
        self._unflushed += entry.size
        # chunk-granularity group commit (256 KB default)
        chunk = self.device.chunk_bytes
        while self._unflushed >= chunk:
            self.device.sequential_write(chunk, chunk, kind=self.kind)
            self._unflushed -= chunk
        return Pointer(seg.segment_id, len(seg.entries) - 1)

    def flush(self) -> None:
        if self._unflushed:
            self.device.sequential_write(self._unflushed, self.device.chunk_bytes, kind=self.kind)
            self._unflushed = 0

    # -- read / invalidate ----------------------------------------------------
    def get(self, ptr: Pointer) -> LogEntry:
        entry = self.segments[ptr.segment_id].entries[ptr.slot]
        assert entry is not None, "dereferenced a GC'd slot"
        return entry

    def read(self, ptr: Pointer, kind: str = "get") -> LogEntry:
        """Get + charge a 4 KB random block read at the entry's device offset."""
        seg = self.segments[ptr.segment_id]
        entry = seg.entries[ptr.slot]
        assert entry is not None
        # approximate intra-segment offset by slot position
        approx_off = seg.offset + (ptr.slot * max(1, seg.used_bytes // max(1, len(seg.entries))))
        self.device.random_read(approx_off, entry.size, kind=kind)
        return entry

    def mark_dead(self, ptr: Pointer) -> None:
        """Update/delete invalidated this entry (GC-region free-space info).

        No-op for already-reclaimed segments: a stale index entry in a deep
        level may outlive the segment its pointer refers to (GC relocated the
        live value under a newer LSN), until compaction merges it away.
        """
        seg = self.segments.get(ptr.segment_id)
        if seg is None or ptr.slot >= len(seg.entries):
            return
        entry = seg.entries[ptr.slot]
        if entry is None:
            return
        # NOTE: the entry stays in the segment — GC still pays a lookup to
        # learn it is dead (the paper's 'lookup cost'); only counters move.
        seg.live_bytes -= entry.size
        seg.dead_bytes += entry.size

    def reclaim(self, segment_id: int) -> None:
        seg = self.segments.pop(segment_id)
        if seg is self._tail:
            self._tail = None
        self.device.free_segment(seg.offset)

    # -- iteration -------------------------------------------------------------
    def iter_segments(self) -> Iterator[Segment]:
        return iter(list(self.segments.values()))

    @property
    def total_bytes(self) -> int:
        return sum(s.used_bytes for s in self.segments.values())

    @property
    def live_bytes(self) -> int:
        return sum(s.live_bytes for s in self.segments.values())


class TransientLog(Log):
    """Medium-KV log whose segments are attached to LSM levels (paper §3.3).

    ``seal_tail`` closes the tail segment (optionally marking it sorted — the
    eager L0 sort of Fig. 4/Fig. 8) and returns its id so the caller can attach
    it to the destination level.  Reclaim happens only via the in-place merge
    at the configured merge level; there is no GC path.
    """

    def seal_tail(self, sorted_segment: bool) -> int | None:
        if self._tail is None:
            return None
        self.flush()
        self._tail.sorted = sorted_segment
        sid = self._tail.segment_id
        self._tail = None
        return sid

    def merge_read(self, segment_id: int) -> list[LogEntry]:
        """Charge the device for fetching one segment during the in-place merge.

        Sorted segments are fetched exactly once, incrementally in 8 KB reads
        (paper Fig. 4).  Unsorted segments devolve to one 4 KB random read per
        KV (paper §3.3 'up to 40x the size of the transient log').
        """
        from .io import BLOCK, MERGE_FETCH

        seg = self.segments[segment_id]
        live = [e for e in seg.entries if e is not None]
        if seg.sorted:
            self.device.sequential_read(seg.used_bytes, MERGE_FETCH, kind="compaction")
        else:
            # random order: one uncached block read per entry
            self.device._read(len(live) * BLOCK, len(live), "compaction")
        return live
