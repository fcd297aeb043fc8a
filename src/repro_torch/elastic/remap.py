"""Elastic fleet planning: minimal-movement N->M shard rescale plans.

This module is the pure planning half of online fleet rescaling (the
execution half — journaled migrations, double-routing, crash recovery —
lives in ``repro.core.range_shard`` / ``repro.core.shard``):

* :func:`plan_rescale` computes a :class:`RescalePlan` for an N->M shard
  change that moves as few keys as possible.  For hash partitioning it is
  the consistent-hashing-style property of mod routing: growing to a
  multiple ``M = k*N`` relocates exactly ``(M-N)/M`` of the keys (each new
  slot ``j`` pulls only the keys whose hash lands on ``j mod M``, all of
  which currently live on the single source ``j mod N``), and shrinking to
  a divisor relocates ``(N-M)/N`` — never a full reshuffle.  For range
  partitioning the plan is quantile-driven: growing adds ``M-N`` boundary
  cuts at the medians of the most populous ranges (keys outside the cut
  spans never move), shrinking drops the boundaries bounding the lightest
  adjacent pairs.

* :class:`RescaleState` is the coordinator bookkeeping for an in-flight
  rescale: which legs remain, the shared device-byte budget per tick, and
  the progress counters surfaced by ``Engine.topology()``.

Every leg is an ordinary journaled migration (``MigrationState`` with a
``rescale_start``/per-leg ``checkpoint``/``rescale_finish`` record stream);
legs on disjoint shard pairs drain concurrently through the executor's
per-shard FIFO queues, admission-controlled by the plan's global budget.

The planner is deliberately store-agnostic — it consumes a :class:`Topology`
value and an optional key sample, and produces positions, not store objects
— so it is unit-testable without building a fleet.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fleet shape: partitioning scheme, shard count, range boundaries."""

    scheme: str                                # "hash" | "range"
    shards: int
    boundaries: tuple[bytes, ...] | None = None

    def __post_init__(self):
        if self.scheme not in ("hash", "range"):
            raise ValueError(f"unknown scheme {self.scheme!r} (hash|range)")
        if self.shards < 1:
            raise ValueError("shards must be >= 1")
        if self.scheme == "range":
            b = self.boundaries
            if b is None or len(b) != self.shards or b[0] != b"":
                raise ValueError(
                    "range topology needs len(boundaries) == shards with boundaries[0] == b''")
            if any(x >= y for x, y in zip(b, b[1:])):
                raise ValueError("boundaries must be strictly increasing")


@dataclasses.dataclass(frozen=True)
class RescaleLeg:
    """One migration leg of a plan, in pre/post-rescale *positions*.

    ``kind`` is ``"split"``/``"merge"`` (range) or ``"hash"``; ``src`` is a
    position in the old map, ``dst`` a position in the new one.  Range legs
    carry the moved span ``[lo, hi)``; hash legs move the keys whose hash
    routes to ``dst`` under the new modulus (``lo``/``hi`` are ``None``).
    """

    kind: str
    src: int
    dst: int
    lo: bytes | None = None
    hi: bytes | None = None


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """A minimal-movement N->M remap: the legs to run and the new shape."""

    scheme: str
    old_shards: int
    new_shards: int
    legs: tuple[RescaleLeg, ...]
    boundaries: tuple[bytes, ...] | None       # range: full post-rescale list
    moved_fraction: float                      # estimated fraction of keys relocated


def _range_grow(boundaries: tuple[bytes, ...], new_shards: int,
                key_sample) -> RescalePlan:
    old_n = len(boundaries)
    ks = sorted(set(key_sample or ()))
    if len(ks) < 2 * (new_shards - old_n):
        raise ValueError(
            "range grow needs a key sample (>= 2 keys per new shard) to place "
            "quantile cuts")
    # fragments: (lo, hi, sorted sample keys inside), refined by repeated
    # median cuts of the heaviest fragment — each cut is one new boundary
    frags: list[tuple[bytes, bytes | None, list[bytes]]] = []
    owner: list[int] = []                      # fragment -> original range
    for i, lo in enumerate(boundaries):
        hi = boundaries[i + 1] if i + 1 < old_n else None
        a = bisect.bisect_left(ks, lo)
        b = bisect.bisect_left(ks, hi) if hi is not None else len(ks)
        frags.append((lo, hi, ks[a:b]))
        owner.append(i)
    cuts_in: dict[int, list[bytes]] = {i: [] for i in range(old_n)}
    for _ in range(new_shards - old_n):
        j = max(range(len(frags)), key=lambda f: len(frags[f][2]))
        lo, hi, keys = frags[j]
        if len(keys) < 2:
            raise ValueError("key sample too thin to cut the heaviest range")
        cut = keys[len(keys) // 2]
        if cut <= lo:
            raise ValueError("key sample too skewed to place a distinct cut")
        cuts_in[owner[j]].append(cut)
        at = keys.index(cut)
        frags[j] = (lo, cut, keys[:at])
        frags.insert(j + 1, (cut, hi, keys[at:]))
        owner.insert(j + 1, owner[j])
    new_bounds: list[bytes] = []
    legs: list[RescaleLeg] = []
    moved = 0
    for i, lo in enumerate(boundaries):
        hi = boundaries[i + 1] if i + 1 < old_n else None
        src_pos = len(new_bounds)
        new_bounds.append(lo)
        cuts = sorted(cuts_in[i])
        for j, cut in enumerate(cuts):
            leg_hi = cuts[j + 1] if j + 1 < len(cuts) else hi
            legs.append(RescaleLeg("split", src_pos, len(new_bounds),
                                   lo=cut, hi=leg_hi))
            new_bounds.append(cut)
        if cuts:
            a = bisect.bisect_left(ks, cuts[0])
            b = bisect.bisect_left(ks, hi) if hi is not None else len(ks)
            moved += b - a
    frac = moved / len(ks) if ks else 0.0
    return RescalePlan("range", old_n, new_shards, tuple(legs),
                       tuple(new_bounds), frac)


def _range_shrink(boundaries: tuple[bytes, ...], new_shards: int,
                  key_sample) -> RescalePlan:
    old_n = len(boundaries)
    drops_needed = old_n - new_shards
    # merge legs retire their source, so two chained merges (shard i+1 into i
    # while i+2 merges into i+1) would make one shard both a source and a
    # destination — dropped boundaries must be non-adjacent, which caps a
    # single rescale at floor(N/2) merges; shrink further stepwise
    if drops_needed > old_n // 2:
        raise ValueError(
            f"range shrink {old_n}->{new_shards} needs {drops_needed} "
            f"non-adjacent merges but only {old_n // 2} fit; rescale stepwise")
    ks = sorted(set(key_sample or ()))

    def pair_weight(t: int) -> int:            # sample keys in shards t-1 and t
        lo = boundaries[t - 1]
        hi = boundaries[t + 1] if t + 1 < old_n else None
        a = bisect.bisect_left(ks, lo)
        b = bisect.bisect_left(ks, hi) if hi is not None else len(ks)
        return b - a

    # exact minimum-weight choice of ``drops_needed`` pairwise non-adjacent
    # boundaries (greedy-by-weight can dead-end on feasible inputs: picking a
    # middle boundary first blocks both neighbours); candidate count == shard
    # count, so the path-DP is trivially cheap
    idxs = list(range(1, old_n))

    @functools.lru_cache(maxsize=None)
    def choose(i: int, c: int):
        if c == 0:
            return (0, ())
        if i >= len(idxs):
            return None
        best = choose(i + 1, c)
        rest = choose(i + 2, c - 1)
        if rest is not None:
            taken = (rest[0] + pair_weight(idxs[i]), (idxs[i],) + rest[1])
            if best is None or taken[0] < best[0]:
                best = taken
        return best

    chosen = choose(0, drops_needed)
    if chosen is None:
        raise ValueError("could not choose non-adjacent merge pairs; rescale stepwise")
    dropped = sorted(chosen[1])
    new_bounds = [b for t, b in enumerate(boundaries) if t not in dropped]
    legs: list[RescaleLeg] = []
    moved = 0
    for t in dropped:
        lo = boundaries[t]
        hi = boundaries[t + 1] if t + 1 < old_n else None
        dst_pos = bisect.bisect_right(new_bounds, boundaries[t - 1]) - 1
        legs.append(RescaleLeg("merge", src=t, dst=dst_pos, lo=lo, hi=hi))
        a = bisect.bisect_left(ks, lo)
        b = bisect.bisect_left(ks, hi) if hi is not None else len(ks)
        moved += b - a
    frac = moved / len(ks) if ks else drops_needed / old_n
    return RescalePlan("range", old_n, new_shards, tuple(legs),
                       tuple(new_bounds), frac)


def plan_rescale(topology: Topology, new_shards: int, *,
                 key_sample=None) -> RescalePlan:
    """Plan a minimal-movement rescale of ``topology`` to ``new_shards``.

    Hash fleets rescale between mod-routing-compatible sizes only — ``M`` a
    multiple of ``N`` (grow; moves ``(M-N)/M`` of keys) or a divisor
    (shrink; moves ``(N-M)/N``) — because any other pair reshuffles nearly
    the whole keyspace, defeating the point.  Range fleets grow by quantile
    cuts of the heaviest ranges (``key_sample`` required) and shrink by
    merging the lightest non-adjacent pairs.  ``M == N`` returns an empty
    plan.  Raises ``ValueError`` on shapes the planner cannot reach in one
    rescale.
    """
    if new_shards < 1:
        raise ValueError("new_shards must be >= 1")
    n, m = topology.shards, new_shards
    if m == n:
        return RescalePlan(topology.scheme, n, m, (), topology.boundaries, 0.0)
    if topology.scheme == "hash":
        if m > n and m % n == 0:
            legs = tuple(RescaleLeg("hash", src=j % n, dst=j)
                         for j in range(n, m))
            return RescalePlan("hash", n, m, legs, None, (m - n) / m)
        if m < n and n % m == 0:
            legs = tuple(RescaleLeg("hash", src=s, dst=s % m)
                         for s in range(m, n))
            return RescalePlan("hash", n, m, legs, None, (n - m) / n)
        raise ValueError(
            f"hash rescale {n}->{m}: minimal movement needs the new count to "
            f"be a multiple or divisor of the old one")
    if m > n:
        return _range_grow(topology.boundaries, m, key_sample)
    return _range_shrink(topology.boundaries, m, key_sample)


@dataclasses.dataclass
class RescaleState:
    """Coordinator bookkeeping for one in-flight rescale.

    The owning front-end holds one of these from ``rescale_start`` to
    ``rescale_finish``.  ``budget`` is the *global* device-bytes-per-tick
    admission budget shared by every concurrent leg (0 = unthrottled);
    ``dst_ids`` maps plan legs to the store-assigned shard ids so per-leg
    ``checkpoint``/``finish`` records can name them; the counters feed
    ``Engine.topology()`` progress reporting.
    """

    plan: RescalePlan
    budget: int = 0
    dst_ids: tuple[int, ...] = ()              # shard id of each leg's dst
    legs_done: int = 0
    keys_moved: int = 0
    ticks: int = 0
    next_leg: int = 0                          # round-robin pointer

    @property
    def legs_total(self) -> int:
        return len(self.plan.legs)

    @property
    def done(self) -> bool:
        return self.legs_done >= self.legs_total

    def progress(self) -> dict:
        return {
            "from_shards": self.plan.old_shards,
            "to_shards": self.plan.new_shards,
            "legs_total": self.legs_total,
            "legs_done": self.legs_done,
            "keys_moved": self.keys_moved,
            "ticks": self.ticks,
            "budget": self.budget,
            "moved_fraction_planned": self.plan.moved_fraction,
        }


__all__ = [
    "RescaleLeg",
    "RescalePlan",
    "RescaleState",
    "Topology",
    "plan_rescale",
]
