"""YCSB workload generator (paper §4, Table 1).

Key/value sizes follow the paper exactly: keys average 24 B; values are 9 B
(small), 104 B (medium), 1004 B (large), giving p = 0.72 / 0.19 / 0.02 with a
12 B prefix.  Mixes: S/M/L are single-size, SD/MD/LD are 60-20-20 dominant
mixes.  Operation mixes follow standard YCSB:

* Load A/E : 100% insert
* Run A    : 50% update / 50% read
* Run B    : 5% update / 95% read
* Run C    : 100% read
* Run D    : 5% insert / 95% read (latest distribution)
* Run E    : 5% insert / 95% scan (short ranges)

Key popularity is zipfian (theta 0.99) like YCSB's default.  The generator is
deterministic given a seed and yields batched numpy arrays so benchmarks can
drive millions of ops without Python-loop overhead in generation.

``execute`` drives any store through an op stream; with ``batch_size > 0`` it
groups consecutive same-kind ops and dispatches them through the batched
``put_many``/``update_many``/``get_many`` APIs of
:class:`repro.core.shard.ShardedStore` (falling back to per-op calls for
stores without them), preserving stream order and visible state.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator

import numpy as np

# warn-once registry for the legacy driver shims (PR 5): the canonical entry
# point is repro.api.execute on a repro.api.open() engine; these module-level
# drivers keep working for one release but nag exactly once per process.
# repro.api.reset_deprecation_warnings() clears this (tests/test_deprecations).
_DEPRECATED_WARNED: set[str] = set()


def _warn_deprecated(symbol: str, replacement: str) -> None:
    if symbol in _DEPRECATED_WARNED:
        return
    _DEPRECATED_WARNED.add(symbol)
    warnings.warn(
        f"{symbol} is deprecated; use {replacement}",
        DeprecationWarning,
        stacklevel=3,
    )

KEY_SIZE = 24
VALUE_SIZES = {"small": 9, "medium": 104, "large": 1004}

MIXES = {  # name -> (small%, medium%, large%)
    "S": (100, 0, 0),
    "M": (0, 100, 0),
    "L": (0, 0, 100),
    "SD": (60, 20, 20),
    "MD": (20, 60, 20),
    "LD": (20, 20, 60),
}

OP_MIXES = {  # name -> dict(op -> fraction)
    "load_a": {"insert": 1.0},
    "load_e": {"insert": 1.0},
    "run_a": {"update": 0.5, "read": 0.5},
    "run_b": {"update": 0.05, "read": 0.95},
    "run_c": {"read": 1.0},
    "run_d": {"insert": 0.05, "read": 0.95},
    "run_e": {"insert": 0.05, "scan": 0.95},
}


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str            # insert | update | read | scan
    key: bytes
    value_size: int = 0  # bytes (payload synthesized on demand)
    scan_len: int = 0


class ZipfGenerator:
    """Bounded zipfian over [0, n) with YCSB's theta=0.99 (rejection-free CDF)."""

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        self.n = n
        ranks = np.arange(1, n + 1, dtype=np.float64)
        weights = 1.0 / np.power(ranks, theta)
        self.cdf = np.cumsum(weights / weights.sum())
        self.rng = np.random.default_rng(seed)
        # shuffle rank->key mapping so hot keys are spread over the keyspace
        self.perm = self.rng.permutation(n)

    def sample(self, count: int) -> np.ndarray:
        u = self.rng.random(count)
        ranks = np.searchsorted(self.cdf, u)
        return self.perm[ranks]


def make_key(i: int) -> bytes:
    return b"user" + str(i).zfill(KEY_SIZE - 4).encode()


def _sizes_for(mix: str, rng: np.random.Generator, count: int) -> np.ndarray:
    s, m, l = MIXES[mix]
    cats = rng.choice(3, size=count, p=np.array([s, m, l]) / 100.0)
    sizes = np.array([VALUE_SIZES["small"], VALUE_SIZES["medium"], VALUE_SIZES["large"]])
    return sizes[cats]


@dataclasses.dataclass
class Workload:
    """A YCSB phase.  ``hot_update_frac``/``hot_update_keys`` add an
    update-distance skew on top of the zipfian key popularity: that fraction
    of the update ops is redirected to a small working set drawn from the
    zipf *head* (the already-popular keys), so their inter-update distances
    collapse — the short-lifetime population the lifetime sketch
    (:mod:`repro.core.lifetime`) is built to catch.  At the default ``0.0``
    no extra randomness is drawn and op streams are byte-identical to
    pre-knob workloads."""

    name: str            # e.g. 'load_a'
    mix: str             # e.g. 'SD'
    num_keys: int        # loaded keyspace size
    num_ops: int         # operations to run (for run_* phases)
    seed: int = 7
    scan_len: int = 50
    hot_update_frac: float = 0.0   # fraction of updates redirected to the hot set
    hot_update_keys: int = 64      # hot working-set size (clamped to num_keys)

    def __post_init__(self):
        if not 0.0 <= self.hot_update_frac <= 1.0:
            raise ValueError(f"hot_update_frac must be in [0, 1], got {self.hot_update_frac}")
        if self.hot_update_keys < 1:
            raise ValueError(f"hot_update_keys must be >= 1, got {self.hot_update_keys}")

    def load_ops(self) -> Iterator[Op]:
        """The load phase: insert every key once, sizes drawn from the mix."""
        rng = np.random.default_rng(self.seed)
        sizes = _sizes_for(self.mix, rng, self.num_keys)
        order = rng.permutation(self.num_keys)
        for i in order:
            yield Op("insert", make_key(int(i)), int(sizes[i]))

    def run_ops(self) -> Iterator[Op]:
        rng = np.random.default_rng(self.seed + 1)
        zipf = ZipfGenerator(self.num_keys, seed=self.seed + 2)
        opmix = OP_MIXES[self.name]
        kinds = list(opmix.keys())
        probs = np.array([opmix[k] for k in kinds])
        choices = rng.choice(len(kinds), size=self.num_ops, p=probs)
        keys = zipf.sample(self.num_ops)
        sizes = _sizes_for(self.mix, rng, self.num_ops)
        # the hot-update stream uses its own generator, drawn ONLY when the
        # knob is on: the base streams above stay byte-identical regardless
        hot_u = hot_pick = None
        if self.hot_update_frac > 0.0:
            hot_rng = np.random.default_rng(self.seed + 3)
            hot_u = hot_rng.random(self.num_ops)
            hot_pick = hot_rng.integers(
                0, min(self.hot_update_keys, self.num_keys), size=self.num_ops
            )
        next_insert = self.num_keys
        for i, (c, k, sz) in enumerate(zip(choices, keys, sizes)):
            kind = kinds[c]
            if kind == "insert":
                yield Op("insert", make_key(next_insert), int(sz))
                next_insert += 1
            elif kind == "update":
                if hot_u is not None and hot_u[i] < self.hot_update_frac:
                    # hot set = the zipf head ranks, mapped through the same
                    # rank->key shuffle the zipf sampler uses
                    k = zipf.perm[hot_pick[i]]
                yield Op("update", make_key(int(k)), int(sz))
            elif kind == "read":
                yield Op("read", make_key(int(k)))
            else:
                yield Op("scan", make_key(int(k)), scan_len=self.scan_len)


_PAYLOAD = bytes(range(256)) * 8  # 2 KB of deterministic filler


def payload(size: int) -> bytes:
    return _PAYLOAD[:size]


def _flush_batch(store, kind: str, batch: list[Op]) -> None:
    """Dispatch one same-kind batch, batched API when the store has one."""
    if not batch:
        return
    if kind == "insert":
        items = [(op.key, payload(op.value_size)) for op in batch]
        if hasattr(store, "put_many"):
            store.put_many(items)
        else:
            for k, v in items:
                store.put(k, v)
    elif kind == "update":
        items = [(op.key, payload(op.value_size)) for op in batch]
        if hasattr(store, "update_many"):
            store.update_many(items)
        else:
            for k, v in items:
                store.update(k, v)
    elif kind == "read":
        keys = [op.key for op in batch]
        if hasattr(store, "get_many"):
            store.get_many(keys)
        else:
            for k in keys:
                store.get(k)
    else:
        for op in batch:
            store.scan(op.key, op.scan_len)


def execute(store, ops: Iterator[Op], gc_every: int = 0, batch_size: int = 0,
            migrate_budget: int = 0) -> dict:
    """Deprecated shim for :func:`_execute` — the serial op-stream driver.

    Use :func:`repro.api.execute` on an engine from :func:`repro.api.open`
    instead: one driver covers every partitioning × execution combination.
    Warns :class:`DeprecationWarning` once per process, then delegates
    unchanged (the differential oracle still replays legacy paths through it).
    """
    _warn_deprecated("repro.core.ycsb.execute",
                     "repro.api.execute(engine, ops, ...) on a repro.api.open() engine")
    return _execute(store, ops, gc_every=gc_every, batch_size=batch_size,
                    migrate_budget=migrate_budget)


def _execute(store, ops: Iterator[Op], gc_every: int = 0, batch_size: int = 0,
             migrate_budget: int = 0) -> dict:
    """Drive a store through an op stream; returns op counts.

    ``batch_size == 0`` (the default) issues one call per op — the original
    single-store path.  With ``batch_size > 0``, consecutive ops of the same
    kind are grouped and dispatched through the store's batched APIs
    (``put_many``/``update_many``/``get_many``, e.g.
    :class:`repro.core.shard.ShardedStore`) when present, falling back to
    per-op calls otherwise.  Batches never cross a kind boundary and apply in
    stream order, so visible state is identical to the sequential path.

    ``migrate_budget > 0`` gives the driver explicit control of incremental
    rebalancing: after every dispatched batch (every op in per-op mode), a
    store exposing ``migration_tick``
    (:class:`repro.core.range_shard.RangeShardedStore`)
    advances its in-flight migration by at most that many keys — the tick
    budget that amortizes shard migration against foreground batches.  Stores
    without the hook ignore it.  (Such stores also self-tick one
    ``migration_batch_keys`` batch at each batch boundary; the explicit
    budget adds driver-paced ticks on top, e.g. to throttle or accelerate.)
    """
    counts = {"insert": 0, "update": 0, "read": 0, "scan": 0}
    tickable = migrate_budget > 0 and hasattr(store, "migration_tick")

    def _tick() -> None:
        if tickable:
            store.migration_tick(migrate_budget)

    if batch_size <= 0:
        # per-op mode: every op is its own "batch", so the driver-paced tick
        # fires after each one
        for n, op in enumerate(ops, 1):
            if op.kind == "insert":
                store.put(op.key, payload(op.value_size))
            elif op.kind == "update":
                store.update(op.key, payload(op.value_size))
            elif op.kind == "read":
                store.get(op.key)
            else:
                store.scan(op.key, op.scan_len)
            counts[op.kind] += 1
            _tick()
            if gc_every and n % gc_every == 0:
                store.gc_tick()
        store.gc_tick()
        return counts

    for ev, kind, batch in _batch_events(ops, batch_size, gc_every, counts):
        if ev == "flush":
            _flush_batch(store, kind, batch)
            _tick()
        else:
            store.gc_tick()
    store.gc_tick()
    return counts


def _batch_events(ops: Iterator[Op], batch_size: int, gc_every: int,
                  counts: dict) -> Iterator[tuple[str, str | None, list[Op]]]:
    """The batch-mode schedule shared by :func:`execute` and
    :func:`execute_async`: yields ``("flush", kind, batch)`` at every batch
    boundary (kind change, full batch, gc position, stream tail) and
    ``("gc", ...)`` at every ``gc_every`` position.  Both drivers consume this
    one generator, so their flush/tick/gc *positions* are identical by
    construction — the async path's byte-identical-to-serial contract cannot
    drift out from under the differential oracle via a one-sided edit.
    ``counts`` is mutated in place (per-op, as ops are consumed)."""
    batch: list[Op] = []
    kind: str | None = None
    n = 0
    for op in ops:
        if kind is not None and (op.kind != kind or len(batch) >= batch_size):
            yield ("flush", kind, batch)
            batch = []
        kind = op.kind
        batch.append(op)
        counts[op.kind] += 1
        n += 1
        if gc_every and n % gc_every == 0:
            yield ("flush", kind, batch)
            yield ("gc", None, [])
            batch, kind = [], None
    if kind is not None:
        yield ("flush", kind, batch)


def _flush_batch_async(ex, kind: str, batch: list[Op]) -> None:
    """Async mirror of :func:`_flush_batch`: shard sub-batches go to the
    executor's queues; the per-batch policy hook (which the store's batched
    ops run inline on the serial path) becomes an executor sequence point.
    Scans run *as* sequence points — :meth:`ShardExecutor.scan` delegates to
    the store's own ``scan``, which feeds the skew window / ticks the policy
    internally, exactly like the serial path."""
    if not batch:
        return
    if kind == "insert":
        ex.put_many([(op.key, payload(op.value_size)) for op in batch])
        ex.after_batch()
    elif kind == "update":
        ex.update_many([(op.key, payload(op.value_size)) for op in batch])
        ex.after_batch()
    elif kind == "read":
        ex.get_many([op.key for op in batch])
        ex.after_batch()
    else:
        for op in batch:
            ex.scan(op.key, op.scan_len)


def execute_async(store, ops: Iterator[Op], *, batch_size: int = 64,
                  workers: int = 4, pipeline: bool = True, gc_every: int = 0,
                  migrate_budget: int = 0, pace: float = 0.0,
                  executor=None) -> dict:
    """Deprecated shim for :func:`_execute_async` — the async-engine driver.

    Use :func:`repro.api.execute` on an engine opened with
    ``execution="async"`` instead.  Warns :class:`DeprecationWarning` once per
    process, then delegates unchanged.
    """
    _warn_deprecated("repro.core.ycsb.execute_async",
                     "repro.api.execute(engine, ops, ...) on an engine opened "
                     "with execution='async'")
    return _execute_async(store, ops, batch_size=batch_size, workers=workers,
                          pipeline=pipeline, gc_every=gc_every,
                          migrate_budget=migrate_budget, pace=pace,
                          executor=executor)


def _execute_async(store, ops: Iterator[Op], *, batch_size: int = 64,
                   workers: int = 4, pipeline: bool = True, gc_every: int = 0,
                   migrate_budget: int = 0, pace: float = 0.0,
                   executor=None) -> dict:
    """Drive a sharded store through an op stream on the async engine.

    Same batching semantics as :func:`execute` with ``batch_size > 0`` —
    consecutive same-kind ops group into batches, policy hooks and the
    optional ``migrate_budget`` tick fire at the same batch boundaries, GC at
    the same ``gc_every`` positions — but batches are routed on the calling
    thread and drained by :class:`repro.core.exec.ShardExecutor`'s per-shard
    queues, pipelined ``pipeline`` deep with ``workers`` pool threads.  The
    scheduling discipline makes results, stats and per-shard device traffic
    byte-identical to ``execute(store, ops, batch_size=batch_size,
    gc_every=gc_every, migrate_budget=migrate_budget)``
    (``tests/test_exec.py``); only wall-clock changes.  ``pace`` converts
    modeled device time into real (GIL-releasing) sleeps so the overlap is
    measurable — see the executor's module docstring.

    Pass ``executor`` to reuse a caller-managed :class:`ShardExecutor`
    (left open on return); otherwise one is created and closed here.
    """
    from .exec import ShardExecutor  # late import: exec builds on this module's peers

    if batch_size < 1:
        raise ValueError("execute_async needs batch_size >= 1 (per-op mode is serial-only)")
    ex = executor or ShardExecutor(store, workers, pipeline=pipeline, pace=pace)
    counts = {"insert": 0, "update": 0, "read": 0, "scan": 0}
    tickable = migrate_budget > 0 and hasattr(store, "migration_tick")

    def _tick() -> None:
        if tickable:
            ex.migration_tick(migrate_budget)

    try:
        for ev, kind, batch in _batch_events(ops, batch_size, gc_every, counts):
            if ev == "flush":
                _flush_batch_async(ex, kind, batch)
                _tick()
            else:
                ex.gc_tick()
        ex.gc_tick()
        ex.drain()
    finally:
        if executor is None:
            ex.close(wait=False)
    return counts
