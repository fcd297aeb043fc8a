"""LSM level structure: per-level sorted index with hybrid entry placement.

Each level is the functional equivalent of the paper's per-level B+-tree: a
sorted run of index entries.  Entries are either *in place* (key+value stored
in the leaf's slot-array/data-segment layout) or *log-placed* (12 B prefix +
8 B pointer in the leaf, value in one of the logs).  We keep the paper's dual
size accounting for medium KVs (§3.3 last paragraph):

* ``index_bytes``  — what the level occupies on the device (pointer-sized for
  log-placed entries).  Used as the level's size when merging *into* it.
* ``logical_bytes`` — full key+value footprint.  Used as the level's size when
  merging it *into the next* level at/after the in-place merge level.

Slot-array overhead (4 B/entry) is charged so the small-KV overhead the paper
reports (≈8 % of leaf capacity, Fig. 6 discussion) is reproduced.

Each level can additionally carry a :class:`BloomFilter` over its key set
(rebuilt with the level on every compaction, like RocksDB's per-SST filter
blocks).  Point reads consult the filter before the leaf probe: a negative
answer lets the store skip the level without touching the device (the
``bloom_skips`` counter in :class:`repro.core.store.StoreStats`).  Filters are
in-memory and deterministic (crc32 double hashing), so they never change the
store's visible state — only its read traffic.
"""
from __future__ import annotations

import bisect
import dataclasses
import zlib

from .logs import Pointer

SLOT = 4          # slot-array cell (paper §3.2)
ENTRY_HEADER = 4  # key/value length headers in the data segment
PREFIX = 12       # fixed index prefix for log-placed KVs (paper §3.1)
POINTER = 8       # log pointer

CAT_SMALL, CAT_MEDIUM, CAT_LARGE = 0, 1, 2


@dataclasses.dataclass
class IndexEntry:
    key: bytes
    lsn: int
    category: int
    tombstone: bool = False
    value: bytes | None = None       # in-place payload
    ptr: Pointer | None = None       # log payload
    log: str | None = None           # which log the pointer refers to ('medium'|'large')
    kv_size: int = 0                 # full key+value size (survives pointer form)
    slot_bytes: int = SLOT           # 0 for packed-SST baselines (RocksDB mode)

    @property
    def in_place(self) -> bool:
        return self.ptr is None

    def index_size(self) -> int:
        """Bytes this entry occupies inside the level on device."""
        if self.tombstone:
            return self.slot_bytes + ENTRY_HEADER + len(self.key)
        if self.in_place:
            return self.slot_bytes + ENTRY_HEADER + len(self.key) + len(self.value or b"")
        return self.slot_bytes + PREFIX + POINTER

    def logical_size(self) -> int:
        return self.slot_bytes + ENTRY_HEADER + self.kv_size if not self.tombstone else self.index_size()


class BloomFilter:
    """Fixed-size bloom filter with crc32 double hashing (deterministic).

    ``h_i(key) = h1 + i*h2 (mod nbits)`` — the standard Kirsch–Mitzenmacher
    construction, so membership answers are identical across processes
    regardless of ``PYTHONHASHSEED``.  May return false positives, never false
    negatives.
    """

    __slots__ = ("nbits", "k", "_bits")

    def __init__(self, num_keys: int, bits_per_key: int = 10):
        self.nbits = max(64, num_keys * bits_per_key)
        # optimal hash count ~= bits_per_key * ln 2
        self.k = max(1, min(16, int(round(bits_per_key * 0.69))))
        self._bits = bytearray((self.nbits + 7) // 8)

    def _positions(self, key: bytes):
        h1 = zlib.crc32(key)
        h2 = zlib.crc32(key, 0x9E3779B9) | 1  # odd so strides cycle the table
        for i in range(self.k):
            yield (h1 + i * h2) % self.nbits

    def add(self, key: bytes) -> None:
        for pos in self._positions(key):
            self._bits[pos >> 3] |= 1 << (pos & 7)

    def __contains__(self, key: bytes) -> bool:
        return all(self._bits[pos >> 3] & (1 << (pos & 7)) for pos in self._positions(key))


class Level:
    """A sorted run of IndexEntry (unique keys, ascending)."""

    def __init__(self, index: int, bloom_bits_per_key: int = 0):
        self.index = index
        self.entries: list[IndexEntry] = []
        self._keys: list[bytes] = []
        self.index_bytes = 0
        self.logical_bytes = 0
        self.transient_segments: list[int] = []  # medium-log segments attached here
        self.bloom_bits_per_key = bloom_bits_per_key
        self.bloom: BloomFilter | None = None

    def __len__(self) -> int:
        return len(self.entries)

    def rebuild(self, entries: list[IndexEntry]) -> None:
        self.entries = entries
        self._keys = [e.key for e in entries]
        self.index_bytes = sum(e.index_size() for e in entries)
        self.logical_bytes = sum(e.logical_size() for e in entries)
        if self.bloom_bits_per_key > 0 and entries:
            self.bloom = BloomFilter(len(entries), self.bloom_bits_per_key)
            for k in self._keys:
                self.bloom.add(k)
        else:
            self.bloom = None

    def maybe_contains(self, key: bytes) -> bool:
        """Filter check for point reads; True when no filter is attached."""
        return self.bloom is None or key in self.bloom

    def clear(self) -> list[int]:
        segs, self.transient_segments = self.transient_segments, []
        self.rebuild([])
        return segs

    def find(self, key: bytes) -> IndexEntry | None:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return self.entries[i]
        return None

    def range(self, start: bytes, count_hint: int) -> list[IndexEntry]:
        i = bisect.bisect_left(self._keys, start)
        return self.entries[i : i + count_hint]

    def iter_from(self, start: bytes):
        i = bisect.bisect_left(self._keys, start)
        while i < len(self.entries):
            yield self.entries[i]
            i += 1


def merge_runs(newer: list[IndexEntry], older: list[IndexEntry], *, drop_tombstones: bool) -> tuple[list[IndexEntry], list[IndexEntry]]:
    """Merge two sorted runs; newer wins on key collision (it has higher LSN).

    Returns (merged, superseded) where ``superseded`` are the shadowed/dropped
    entries — the caller uses them to mark log slots dead (GC-region info,
    paper §3.2) .
    """
    merged: list[IndexEntry] = []
    dead: list[IndexEntry] = []
    i = j = 0
    while i < len(newer) and j < len(older):
        a, b = newer[i], older[j]
        if a.key < b.key:
            merged.append(a)
            i += 1
        elif a.key > b.key:
            merged.append(b)
            j += 1
        else:
            # same key: newer shadows older
            dead.append(b)
            merged.append(a)
            i += 1
            j += 1
    merged.extend(newer[i:])
    merged.extend(older[j:])
    if drop_tombstones:
        out = []
        for e in merged:
            if e.tombstone:
                dead.append(e)
            else:
                out.append(e)
        merged = out
    return merged, dead
