"""Byte-accounted storage model.

The paper measures I/O amplification as *device traffic (reads+writes) over
application traffic* on an NVMe device.  This container has no block device,
so we model the device as a byte-accounting object that enforces the paper's
access granularities:

* reads from index/log during gets & GC lookups: 4 KB random blocks (§3.4)
* log appends: 256 KB chunks of 2 MB segments (§3.4)
* compaction reads/writes: 2 MB segment granularity (§3.4)
* transient-log fetch during last-level merge: 8 KB sequential sub-reads of
  each segment when sorted, 4 KB random per-KV reads when unsorted (§3.3/§5)

A small block cache models the user-space/mmap cache of Table 1 so that read
traffic (Run A-E, GC lookups) behaves like the paper's: hits are free,
misses cost a 4 KB block read.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

KB = 1024
MB = 1024 * KB

BLOCK = 4 * KB          # random-read granularity
CHUNK = 256 * KB        # log append chunk
SEGMENT = 2 * MB        # allocation / compaction granularity
MERGE_FETCH = 8 * KB    # sorted transient-log fetch granularity


@dataclasses.dataclass
class DeviceStats:
    bytes_read: int = 0
    bytes_written: int = 0
    read_ops: int = 0
    write_ops: int = 0
    # attributed sub-counters (all already included in the totals above)
    gc_read: int = 0
    gc_written: int = 0
    compaction_read: int = 0
    compaction_written: int = 0
    log_written: int = 0
    meta_written: int = 0       # shard-metadata WAL records (boundary/migration)
    get_read: int = 0
    # lifetime-class breakdown (repro.core.lifetime): the short-lived value
    # log's traffic, *also* included in gc_read/log_written above so the
    # aggregate counters keep their meaning with lifetime on or off
    gc_short_read: int = 0      # GC identification reads over short-class logs
    short_log_written: int = 0  # appends (writes + relocations) to short logs

    @property
    def total(self) -> int:
        return self.bytes_read + self.bytes_written

    def snapshot(self) -> "DeviceStats":
        return dataclasses.replace(self)

    def delta(self, since: "DeviceStats") -> "DeviceStats":
        return DeviceStats(
            **{
                f.name: getattr(self, f.name) - getattr(since, f.name)
                for f in dataclasses.fields(self)
            }
        )


class BlockCache:
    """LRU cache of 4 KB block ids (models Table 1 cache / mmap DRAM)."""

    def __init__(self, capacity_bytes: int):
        self.capacity_blocks = max(0, capacity_bytes // BLOCK)
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, block_id: int) -> bool:
        """Touch a block; returns True on hit."""
        if self.capacity_blocks == 0:
            self.misses += 1
            return False
        if block_id in self._lru:
            self._lru.move_to_end(block_id)
            self.hits += 1
            return True
        self.misses += 1
        self._lru[block_id] = None
        if len(self._lru) > self.capacity_blocks:
            self._lru.popitem(last=False)
        return False

    def invalidate_range(self, first_block: int, nblocks: int) -> None:
        for b in range(first_block, first_block + nblocks):
            self._lru.pop(b, None)


class Device:
    """Byte-accounting device with granularity rounding and a block cache.

    Offsets are virtual: the allocator hands out segment-aligned extents and
    the device only tracks traffic, not contents (contents live in the store's
    functional state).  ``bandwidth`` numbers are used by benchmarks to turn
    byte counts into a device-time proxy (Intel P4800X-like: ~2.4/2.0 GB/s).
    """

    def __init__(
        self,
        cache_bytes: int = 0,
        read_bw: float = 2.4e9,
        write_bw: float = 2.0e9,
        segment_bytes: int = SEGMENT,
        chunk_bytes: int = CHUNK,
    ):
        self.stats = DeviceStats()
        self.cache = BlockCache(cache_bytes)
        self.read_bw = read_bw
        self.write_bw = write_bw
        self.segment_bytes = segment_bytes
        self.chunk_bytes = chunk_bytes
        self._next_segment = 0
        self._free_segments: list[int] = []

    # -- allocation ---------------------------------------------------------
    def alloc_segment(self) -> int:
        """Returns the segment-aligned device offset of a fresh segment."""
        if self._free_segments:
            return self._free_segments.pop()
        off = self._next_segment * self.segment_bytes
        self._next_segment += 1
        return off

    def free_segment(self, offset: int) -> None:
        assert offset % self.segment_bytes == 0, offset
        self.cache.invalidate_range(offset // BLOCK, self.segment_bytes // BLOCK)
        self._free_segments.append(offset)

    @property
    def allocated_segments(self) -> int:
        return self._next_segment - len(self._free_segments)

    # -- raw accounting -----------------------------------------------------
    def _read(self, nbytes: int, ops: int, kind: str) -> None:
        self.stats.bytes_read += nbytes
        self.stats.read_ops += ops
        if kind == "gc":
            self.stats.gc_read += nbytes
        elif kind == "gc_short":
            self.stats.gc_read += nbytes
            self.stats.gc_short_read += nbytes
        elif kind == "compaction":
            self.stats.compaction_read += nbytes
        elif kind == "get":
            self.stats.get_read += nbytes

    def _write(self, nbytes: int, ops: int, kind: str) -> None:
        self.stats.bytes_written += nbytes
        self.stats.write_ops += ops
        if kind == "gc":
            self.stats.gc_written += nbytes
        elif kind == "compaction":
            self.stats.compaction_written += nbytes
        elif kind == "log":
            self.stats.log_written += nbytes
        elif kind == "short_log":
            self.stats.log_written += nbytes
            self.stats.short_log_written += nbytes
        elif kind == "meta":
            self.stats.meta_written += nbytes

    # -- modeled operations --------------------------------------------------
    # contract: single-threaded
    def random_read(self, offset: int, nbytes: int, kind: str = "get") -> None:
        """4 KB-granular random read through the block cache."""
        first = offset // BLOCK
        last = (offset + max(1, nbytes) - 1) // BLOCK
        miss_blocks = sum(0 if self.cache.access(b) else 1 for b in range(first, last + 1))
        if miss_blocks:
            self._read(miss_blocks * BLOCK, miss_blocks, kind)

    def sequential_read(self, nbytes: int, granularity: int = SEGMENT, kind: str = "compaction") -> None:
        """Direct-I/O sequential read (bypasses cache, like compaction reads)."""
        if nbytes <= 0:
            return
        ops = -(-nbytes // granularity)
        self._read(ops * min(granularity, max(nbytes, 1)) if ops == 1 else nbytes, ops, kind)

    # contract: single-threaded
    def sequential_write(self, nbytes: int, granularity: int = CHUNK, kind: str = "log") -> None:
        """Direct-I/O append/compaction write at chunk/segment granularity."""
        if nbytes <= 0:
            return
        ops = -(-nbytes // granularity)
        self._write(nbytes, ops, kind)

    def device_time(self, stats: DeviceStats | None = None) -> float:
        s = stats or self.stats
        return s.bytes_read / self.read_bw + s.bytes_written / self.write_bw


# ---------------------------------------------------------------- overlap
# Sharded front-ends own one Device per shard; turning N per-device times
# into one completion time is a *policy*, and the paper's headline wins come
# precisely from which policy the execution engine can realize (overlapped,
# mostly-sequential I/O keeping the NVMe device busy).  Three are modeled:
#
# * ``serial``       — no overlap: the batch waits for every device in turn
#                      (one channel; what shard-by-shard execution realizes)
# * ``ideal``        — perfect overlap: the slowest device bounds the batch
#                      (infinite channels; the former ``device_time = max``)
# * ``channels:k``   — k parallel NVMe channels: per-shard times are packed
#                      onto k channels LPT-first (longest processing time on
#                      the least-loaded channel) and the makespan is the
#                      completion time.  ``channels:1 == serial``;
#                      ``channels:k >= N == ideal``.
#
# ``repro.core.exec.ShardExecutor``'s paced mode turns the same per-shard
# times into *measured* wall-clock so model and measurement can be compared
# per benchmark (see docs/execution.md).

OVERLAP_POLICIES = ("serial", "ideal", "channels:<k>")


def overlap_time(times: "list[float]", policy: str = "ideal") -> float:
    """Combine per-device busy times into one completion time under a policy.

    ``policy`` is ``"serial"``, ``"ideal"``, or ``"channels:k"`` (k >= 1).
    LPT packing is deterministic: ties go to the lowest-indexed channel, and
    equal times keep their input order (Python's sort is stable).
    """
    ts = [t for t in times if t > 0.0]
    if not ts:
        return 0.0
    if policy == "serial":
        return float(sum(ts))
    if policy == "ideal":
        return float(max(ts))
    if policy.startswith("channels:"):
        k = int(policy.split(":", 1)[1])
        if k < 1:
            raise ValueError(f"channels policy needs k >= 1, got {k}")
        loads = [0.0] * min(k, len(ts))
        for t in sorted(ts, reverse=True):
            i = min(range(len(loads)), key=loads.__getitem__)
            loads[i] += t
        return max(loads)
    raise ValueError(f"unknown overlap policy {policy!r}; expected one of {OVERLAP_POLICIES}")
