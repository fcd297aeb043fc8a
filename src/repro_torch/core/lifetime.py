"""Lifetime-aware value placement: a windowed per-key update-distance sketch.

The paper's small/medium/large triage is *static*: thresholds are fixed at
config time and the Large log pays full §4 GC regardless of how hot its keys
are.  Related work (HashKV's hotness-grouped value logs, DumpKV's
update-lifetime-driven placement, Scavenger's space/GC trade — see PAPERS.md)
shows the remaining GC/amplification headroom comes from *update-lifetime*
signals: values that die young should live together in logs that are cheap to
clean (mostly-dead segments), values that live long should ride untouched.

This module is the signal side of that design:

* :class:`LifetimeSketch` — a paired-epoch count-min sketch over update
  counts plus a per-cell last-update-LSN table and a ring of recent
  inter-update distances.  ``classify`` maps a key to :data:`CLASS_SHORT`
  (updated ≥ ``hot_updates`` times inside the sliding two-epoch window — it
  will die young) or :data:`CLASS_LONG` (everything else, including keys
  never seen: fresh inserts must prove themselves hot).  The store keeps one
  sketch per instance and routes Large values to a per-class value log
  (``ParallaxStore.short_log`` vs ``large_log``).
* :func:`propose_cutoffs` — the adaptive-threshold controller: turns the
  observed distance ring into a medium/large cutoff (``t_ml``) proposal, so
  update-heavy stores push hot mediums into the aggressively-GC'd short log
  instead of paying in-place merge I/O for values that die young.
* :class:`LifetimeOracle` — an exact reference twin (per-key update lists,
  brute-force collision mass) used by the property tests: the sketch's
  estimate must equal ``true_count + min-over-rows collision mass`` exactly,
  and may never underestimate.

Determinism contract: everything here is keyed with ``zlib.crc32`` under
fixed seeds — builtin ``hash()`` is ``PYTHONHASHSEED``-randomized and banned
from modeled paths (lint rule ``no-nondeterminism``).  Two processes feeding
the same ``(key, lsn)`` stream hold bit-identical sketch state, which is what
lets the differential oracle replay lifetime-enabled engines across serial
and async front-ends.

Windowing: epochs are ``lsn // window``.  The sketch holds the current and
previous epoch's counters; ``estimate`` sums both, so a key's visibility
decays to zero after two epoch rotations without an update — window eviction
can never resurrect a decayed key because rotation only ever zeroes
counters.  The last-LSN table is deliberately not rotated: a stale cell only
*overestimates* recency for colliding keys, which biases toward
:data:`CLASS_SHORT` — the conservative direction (a wrongly-short value costs
one extra relocation; a wrongly-long value pollutes the lazy log).
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque

CLASS_SHORT = "short"
CLASS_LONG = "long"

_SEED_BASE = zlib.crc32(b"repro.core.lifetime")


@dataclasses.dataclass(frozen=True)
class LifetimeConfig:
    """Knobs for the sketch and the per-class GC/placement policy.

    Frozen so one config can safely be shared across the shards of a
    front-end (``StoreConfig`` instances are shared the same way).
    """

    window: int = 2048          # LSNs per sketch epoch (sliding pair = 2x this)
    rows: int = 4               # count-min rows
    width: int = 256            # counters per row
    hot_updates: int = 2        # windowed estimate >= this => CLASS_SHORT
    ring_size: int = 128        # recent inter-update distances kept
    adaptive: bool = True       # adapt t_ml from the observed distance ring
    adapt_every: int = 2048     # LSNs between cutoff proposals
    min_ring: int = 32          # distance samples needed before proposing
    max_shift: float = 0.5      # t_ml may move this fraction of (t_sm - t_ml)
    # Per-class GC thresholds, replacing the single static gc_threshold.
    # The short log waits for a segment to be half dead — hot churn gets it
    # there within about one update cycle, so sweeps fire constantly but
    # relocate little (sweeping hot segments while mostly live is the
    # classic hot/cold-mixing tax this split exists to avoid).  The long
    # log is lazier than the static 0.10 anchor: its live values are cold,
    # so relocating them buys nothing until real garbage accumulates.
    short_gc_threshold: float = 0.5
    long_gc_threshold: float = 0.30

    def __post_init__(self):
        if self.window < 2 or self.rows < 1 or self.width < 1:
            raise ValueError(f"degenerate sketch geometry {self!r}")
        if self.hot_updates < 1:
            raise ValueError("hot_updates must be >= 1")
        if not 0.0 < self.short_gc_threshold <= 1.0 or not 0.0 < self.long_gc_threshold <= 1.0:
            raise ValueError("per-class GC thresholds must be in (0, 1]")


class LifetimeSketch:
    """Paired-epoch count-min over update counts, crc32-keyed.

    ``observe(key, lsn)`` must be fed application writes in LSN order (the
    store's write path does); ``estimate``/``classify`` are read-only.
    """

    def __init__(self, config: LifetimeConfig):
        self.config = config
        self._seeds = [zlib.crc32(b"row-%d" % r, _SEED_BASE) for r in range(config.rows)]
        w = config.width
        self.epoch = 0
        self._cur = [[0] * w for _ in range(config.rows)]
        self._prev = [[0] * w for _ in range(config.rows)]
        self._last = [[0] * w for _ in range(config.rows)]   # cell last-update LSN
        self.ring: deque[int] = deque(maxlen=config.ring_size)
        self.observed = 0
        self.rotations = 0

    # ------------------------------------------------------------- internals
    def _cells(self, key: bytes) -> list[int]:
        w = self.config.width
        return [zlib.crc32(key, seed) % w for seed in self._seeds]

    def _rotate_to(self, epoch: int) -> None:
        if epoch <= self.epoch:
            return
        w = self.config.width
        if epoch == self.epoch + 1:
            self._prev = self._cur
        else:
            # jumped >= 2 epochs: both windows decayed
            self._prev = [[0] * w for _ in range(self.config.rows)]
        self._cur = [[0] * w for _ in range(self.config.rows)]
        self.rotations += 1
        self.epoch = epoch

    # ----------------------------------------------------------------- feed
    def observe(self, key: bytes, lsn: int) -> None:
        cfg = self.config
        self._rotate_to(lsn // cfg.window)
        cells = self._cells(key)
        # distance sample: only when the key is visible in the paired window,
        # so first touches (and decayed keys) don't pollute the ring.  The
        # cell last-LSN is a max over colliding keys, so the sampled distance
        # is <= the key's true distance — conservative toward CLASS_SHORT.
        if all(self._cur[r][c] + self._prev[r][c] > 0 for r, c in enumerate(cells)):
            dist = lsn - min(self._last[r][c] for r, c in enumerate(cells))
            if dist > 0:
                self.ring.append(dist)
        for r, c in enumerate(cells):
            self._cur[r][c] += 1
            if lsn > self._last[r][c]:
                self._last[r][c] = lsn
        self.observed += 1

    # ---------------------------------------------------------------- reads
    def estimate(self, key: bytes) -> int:
        """Windowed update-count estimate: never underestimates the true
        count inside the current+previous epoch window."""
        return min(
            self._cur[r][c] + self._prev[r][c] for r, c in enumerate(self._cells(key))
        )

    def classify(self, key: bytes) -> str:
        return CLASS_SHORT if self.estimate(key) >= self.config.hot_updates else CLASS_LONG

    def state(self) -> dict:
        """Cheap observability snapshot for the stats namespace."""
        ring = sorted(self.ring)
        return {
            "epoch": self.epoch,
            "observed": self.observed,
            "rotations": self.rotations,
            "ring_len": len(ring),
            "median_distance": ring[len(ring) // 2] if ring else None,
        }


def propose_cutoffs(base, distances, window: int, *,
                    min_ring: int = 32, max_shift: float = 0.5) -> tuple[float, float] | None:
    """Adaptive medium/large cutoff from the observed distance distribution.

    ``base`` is the store's *static* :class:`~repro.core.model.SizePolicy`
    (the anchor the controller interpolates from — adaptation is stateless in
    the sense that the same ring always yields the same proposal, so replaying
    a cutover WAL record reproduces the applied policy exactly).

    The rule: the hot fraction of the ring (distances within ``window // 4``
    LSNs — updates arriving well inside one epoch) moves ``t_ml`` up toward
    ``t_sm`` by at most ``max_shift`` of the gap.  A hot, update-heavy store
    therefore reclassifies its mediums as Large — they land in the short-lived
    value log where GC is nearly free (mostly-dead segments) instead of being
    repeatedly rewritten by in-place merges; a cold store keeps the paper's
    static triage.  Returns ``(t_sm, t_ml)`` rounded to 6 decimals (stable
    WAL-record encoding), or None with too few samples.
    """
    distances = list(distances)
    if len(distances) < min_ring:
        return None
    hot_cut = max(1, window // 4)
    hot_frac = sum(1 for d in distances if d <= hot_cut) / len(distances)
    t_ml = round(base.t_ml + (base.t_sm - base.t_ml) * max_shift * hot_frac, 6)
    return (base.t_sm, t_ml)


class LifetimeOracle:
    """Exact reference twin for the sketch (test-only, O(keys) memory).

    Tracks every key's update LSNs and recomputes, by brute force, precisely
    what a collision-aware count-min must report: for each row the cell value
    is the sum of windowed true counts of *all* keys mapping there, and the
    estimate is the min over rows.  ``expected_estimate`` is therefore not a
    bound but an equality the sketch must hit exactly.
    """

    def __init__(self, config: LifetimeConfig):
        self.config = config
        self._seeds = [zlib.crc32(b"row-%d" % r, _SEED_BASE) for r in range(config.rows)]
        self.updates: dict[bytes, list[int]] = {}
        self.epoch = 0

    def observe(self, key: bytes, lsn: int) -> None:
        self.updates.setdefault(key, []).append(lsn)
        self.epoch = max(self.epoch, lsn // self.config.window)

    def true_count(self, key: bytes) -> int:
        """Updates inside the current+previous epoch window."""
        lo = (self.epoch - 1) * self.config.window
        return sum(1 for lsn in self.updates.get(key, ()) if lsn >= lo)

    def _cell(self, key: bytes, row: int) -> int:
        return zlib.crc32(key, self._seeds[row]) % self.config.width

    def expected_estimate(self, key: bytes) -> int:
        per_row = []
        for r in range(self.config.rows):
            cell = self._cell(key, r)
            mass = sum(
                self.true_count(other)
                for other in self.updates
                if self._cell(other, r) == cell
            )
            per_row.append(mass)
        return min(per_row) if per_row else 0

    def classify(self, key: bytes) -> str:
        short = self.expected_estimate(key) >= self.config.hot_updates
        return CLASS_SHORT if short else CLASS_LONG


__all__ = [
    "CLASS_LONG",
    "CLASS_SHORT",
    "LifetimeConfig",
    "LifetimeOracle",
    "LifetimeSketch",
    "propose_cutoffs",
]
