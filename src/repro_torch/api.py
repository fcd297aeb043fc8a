"""Unified engine API: one declarative entry point over every front-end.

The reproduction has grown three front-ends (:class:`~repro_torch.core.store.ParallaxStore`,
:class:`~repro_torch.core.shard.ShardedStore`, :class:`~repro_torch.core.range_shard.RangeShardedStore`)
and two execution modes (serial and :class:`~repro_torch.core.exec.ShardExecutor`
async), with knobs smeared across constructors and ``ycsb.execute`` kwargs.
This module is the single surface in front of all of them:

    import repro_torch.api as api

    cfg = api.EngineConfig(
        store=StoreConfig(mode="parallax", bloom_bits_per_key=10),
        partitioning="range:4",          # "none" | "hash:<N>" | "range:<N>"
        execution="async",               # "serial" | "async"
    )
    with api.open(cfg) as db:
        db.put(b"k", b"v")
        with db.write_batch() as wb:     # buffered, applied at a sequence point
            wb.put(b"a", b"1").delete(b"k")
        it = db.iterator(b"a")           # lazy RocksDB-style cursor
        while it.valid():
            print(it.key(), it.value())
            it.next()
        api.execute(db, workload_ops)    # the one YCSB op-stream driver
        print(db.stats()["device"])

Design rules:

* **Declarative config.**  :class:`EngineConfig` is a validated dataclass tree
  — placement (:class:`~repro_torch.core.store.StoreConfig`), partitioning
  (:class:`PartitioningConfig`: scheme + rebalance/migration budgets),
  execution (:class:`ExecutionConfig`: workers/pipeline/pace/overlap policy)
  and driver defaults.  ``partitioning``/``execution`` accept shorthand
  strings.  Invalid combinations fail at :func:`open` with a
  :class:`ConfigError` naming the field and the accepted forms.

* **One operation surface.**  ``put/get/delete/update``, :class:`WriteBatch`
  (replaces ad-hoc ``put_many``/``update_many``/``delete_many`` call
  patterns), a lazy :class:`Iterator` (replaces eager ``scan(start, count)``
  list materialization — the range back-end streams shard-by-shard, the hash
  back-end k-way merges incrementally), lifecycle (``close``, context
  manager, ``crash()``/``recover()`` for tests), namespaced
  :meth:`Engine.stats` and :meth:`Engine.device_time`.

* **Byte-identical to the legacy paths.**  The engine composes the existing
  front-ends and drivers rather than reimplementing them, so results,
  ``StoreStats``, ``DeviceStats`` and metadata-WAL record streams match the
  legacy call patterns exactly — ``tests/test_differential.py`` /
  ``tests/test_exec.py`` enforce this for every partitioning × execution
  combination.  ``partitioning="none"`` with async execution wraps a 1-shard
  hash front-end (op-for-op identical to the bare store) because the executor
  needs the batched-front-end plumbing.

* **Escape hatch.**  :attr:`Engine.store` exposes the backing front-end for
  maintenance/test surfaces the uniform API does not wrap (``split``,
  ``metalog``, per-shard devices).  With async execution, touch it only when
  no driver call is in flight (every ``api.execute`` returns drained).

The legacy module-level drivers (``repro_torch.core.ycsb.execute`` /
``execute_async``) remain as thin deprecation shims for one release — they
warn once per process and delegate unchanged (``tests/test_deprecations.py``).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Iterable, Iterator as _TypingIterator

from repro_torch.checkpoint.atomic import atomic_write_bytes
from repro_torch.core import ycsb as _ycsb
from repro_torch.core.exec import ShardExecutor
from repro_torch.core.io import overlap_time
from repro_torch.core.lifetime import LifetimeConfig
from repro_torch.core.range_shard import RangeShardedStore
from repro_torch.core.shard import ShardedStore
from repro_torch.core.store import ParallaxStore, StoreConfig


# --------------------------------------------------------------------- errors
class EngineError(Exception):
    """Base class for every error raised by the :mod:`repro_torch.api` surface."""


class ClosedError(EngineError):
    """An operation was attempted on a closed :class:`Engine`."""


class ConfigError(EngineError, ValueError):
    """An :class:`EngineConfig` (or a driver override) is invalid.

    Also a :class:`ValueError` so call-sites written against the legacy
    constructors' error contract keep catching it.
    """


_PARTITIONING_FORMS = "'none', 'hash:<N>', 'range:<N>'"
_EXECUTION_FORMS = "'serial', 'async'"


# --------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class PartitioningConfig:
    """How the keyspace is partitioned, plus the range-scheme policy knobs.

    ``scheme`` is ``"none"`` (one bare store), ``"hash"`` (crc32 routing over
    ``shards`` stores) or ``"range"`` (contiguous key ranges; ``boundaries``
    pre-splits explicitly, otherwise ``shards`` uniform byte-prefix ranges).
    The remaining fields mirror :class:`~repro_torch.core.range_shard.RangeShardedStore`'s
    rebalance/migration knobs and are ignored by the other schemes;
    ``migrate_budget`` is the driver-paced migration tick budget per batch
    (``repro_torch.api.execute``'s default for this engine); ``rescale_budget`` is
    the default :meth:`Engine.rescale` admission budget — device bytes per
    migration tick shared across all concurrent rescale legs (0 =
    unthrottled) — and applies to both sharded schemes.
    """

    scheme: str = "none"
    shards: int = 1
    boundaries: tuple[bytes, ...] | None = None
    rebalance_window: int = 1024
    split_factor: float = 2.0
    merge_factor: float = 0.25
    min_split_keys: int = 32
    max_shards: int = 64
    auto_rebalance: bool = True
    migration_batch_keys: int = 128
    migrate_budget: int = 0
    rescale_budget: int = 0

    @classmethod
    def parse(cls, spec: "PartitioningConfig | str", **kw) -> "PartitioningConfig":
        """Coerce a shorthand string (``"none"``, ``"hash:4"``, ``"range:8"``)
        into a config; extra kwargs become field overrides."""
        if isinstance(spec, cls):
            return dataclasses.replace(spec, **kw) if kw else spec
        if not isinstance(spec, str):
            raise ConfigError(
                f"partitioning must be a PartitioningConfig or one of "
                f"{_PARTITIONING_FORMS}, got {type(spec).__name__}"
            )
        s = spec.strip()
        if s == "none":
            return cls(scheme="none", shards=1, **kw)
        scheme, sep, count = s.partition(":")
        if scheme in ("hash", "range"):
            if not sep:
                raise ConfigError(
                    f"partitioning {spec!r} is missing its shard count; "
                    f"expected one of {_PARTITIONING_FORMS}"
                )
            try:
                shards = int(count)
            except ValueError:
                raise ConfigError(
                    f"partitioning {spec!r} has a non-integer shard count "
                    f"{count!r}; expected one of {_PARTITIONING_FORMS}"
                ) from None
            return cls(scheme=scheme, shards=shards, **kw)
        raise ConfigError(
            f"unknown partitioning {spec!r}; expected one of {_PARTITIONING_FORMS}"
        )

    @classmethod
    def range_for_keys(cls, keys: Iterable[bytes], shards: int, **kw) -> "PartitioningConfig":
        """Range scheme pre-split on a key sample (equal-population quantiles,
        the declarative form of ``RangeShardedStore.for_keys``)."""
        bounds = tuple(RangeShardedStore.boundaries_for_keys(keys, shards))
        return cls(scheme="range", shards=len(bounds), boundaries=bounds, **kw)

    def validate(self) -> None:
        if self.scheme not in ("none", "hash", "range"):
            raise ConfigError(
                f"unknown partitioning scheme {self.scheme!r}; "
                f"expected one of {_PARTITIONING_FORMS}"
            )
        if self.shards < 1:
            raise ConfigError(
                f"partitioning needs a positive shard count, got {self.shards} "
                f"(scheme {self.scheme!r})"
            )
        if self.scheme == "none" and self.shards != 1:
            raise ConfigError(
                f"partitioning 'none' is a single store; got shards={self.shards} "
                f"— use 'hash:{self.shards}' or 'range:{self.shards}'"
            )
        if self.boundaries is not None:
            if self.scheme != "range":
                raise ConfigError(
                    f"boundaries only apply to range partitioning, not {self.scheme!r}"
                )
            if not self.boundaries or self.boundaries[0] != b"":
                raise ConfigError(
                    "range boundaries must start with b'' (shard 0 owns the keyspace head)"
                )
            if any(a >= b for a, b in zip(self.boundaries, self.boundaries[1:])):
                raise ConfigError("range boundaries must be strictly increasing")
        for field, minimum in (("rebalance_window", 1), ("min_split_keys", 1),
                               ("max_shards", 1), ("migration_batch_keys", 1),
                               ("migrate_budget", 0), ("rescale_budget", 0)):
            if getattr(self, field) < minimum:
                raise ConfigError(
                    f"partitioning.{field} must be >= {minimum}, got {getattr(self, field)}"
                )

    @property
    def num_shards(self) -> int:
        return len(self.boundaries) if self.boundaries is not None else self.shards

    def tag(self) -> str:
        return "none" if self.scheme == "none" else f"{self.scheme}{self.num_shards}"


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How batches execute: serial (the historical inline path) or async
    (:class:`~repro_torch.core.exec.ShardExecutor` per-shard queues).  ``overlap``
    is the default device-overlap policy for :meth:`Engine.device_time`
    (``"serial"`` / ``"ideal"`` / ``"channels:<k>"``); ``pace`` converts
    modeled device time into real sleeps and is async-only."""

    mode: str = "serial"
    workers: int = 4
    pipeline: bool = True
    pace: float = 0.0
    max_pending: int = 8
    overlap: str = "ideal"

    @classmethod
    def parse(cls, spec: "ExecutionConfig | str", **kw) -> "ExecutionConfig":
        if isinstance(spec, cls):
            return dataclasses.replace(spec, **kw) if kw else spec
        if not isinstance(spec, str):
            raise ConfigError(
                f"execution must be an ExecutionConfig or one of "
                f"{_EXECUTION_FORMS}, got {type(spec).__name__}"
            )
        s = spec.strip()
        if s in ("serial", "async"):
            return cls(mode=s, **kw)
        raise ConfigError(
            f"unknown execution mode {spec!r}; expected one of {_EXECUTION_FORMS}"
        )

    def validate(self) -> None:
        if self.mode not in ("serial", "async"):
            raise ConfigError(
                f"unknown execution mode {self.mode!r}; expected one of {_EXECUTION_FORMS}"
            )
        if self.workers < 1:
            raise ConfigError(f"execution.workers must be >= 1, got {self.workers}")
        if self.max_pending < 1:
            raise ConfigError(f"execution.max_pending must be >= 1, got {self.max_pending}")
        if self.pace < 0:
            raise ConfigError(f"execution.pace must be >= 0, got {self.pace}")
        if self.pace > 0 and self.mode == "serial":
            raise ConfigError(
                f"execution.pace={self.pace} requires mode 'async': the serial "
                "driver never sleeps modeled device time"
            )
        try:
            overlap_time([1.0], self.overlap)
        except ValueError as e:
            raise ConfigError(f"bad execution.overlap policy: {e}") from None

    def tag(self) -> str:
        if self.mode == "serial":
            return "serial"
        return f"async{self.workers}" + ("" if self.pipeline else "np")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The declarative engine description :func:`open` consumes.

    One validated tree: ``store`` places bytes (mode/thresholds/blooms/GC —
    taken as-is, including ``bloom_bits_per_key``), ``partitioning`` shapes
    the fleet, ``execution`` schedules it, and ``batch_size``/``gc_every``
    are the driver defaults :func:`execute` falls back to.  ``partitioning``
    and ``execution`` accept shorthand strings (``"hash:4"``, ``"async"``).
    ``batch_size=None`` means auto: per-op for a bare serial store (the
    legacy single-store path), 64 otherwise.

    ``debug_checks=True`` attaches the :mod:`repro_torch.analysis.racecheck`
    lockset race detector to the engine (also switchable fleet-wide with the
    ``REPRO_DEBUG_CHECKS`` env var); results and stats stay byte-identical,
    and a clean :meth:`Engine.close` raises
    :class:`~repro_torch.analysis.racecheck.RaceViolation` if any access raced.
    When off (the default) the detector module is never even imported.

    ``snapshot_dir`` is the default home for :meth:`Engine.snapshot`
    manifests (``snapshot-<n>.json``; an explicit ``path`` argument always
    wins).  ``truncate_on_snapshot`` controls whether a snapshot of a
    range-partitioned engine also truncates the shard-metadata WAL down to
    the snapshot record (the default — recovery then replays O(delta)
    records); set it ``False`` to keep the full record history.
    """

    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    partitioning: PartitioningConfig | str = dataclasses.field(default_factory=PartitioningConfig)
    execution: ExecutionConfig | str = dataclasses.field(default_factory=ExecutionConfig)
    batch_size: int | None = None
    gc_every: int = 0
    debug_checks: bool = False
    snapshot_dir: str | None = None
    truncate_on_snapshot: bool = True

    def __post_init__(self):
        object.__setattr__(self, "partitioning", PartitioningConfig.parse(self.partitioning))
        object.__setattr__(self, "execution", ExecutionConfig.parse(self.execution))

    def validate(self) -> "EngineConfig":
        if not isinstance(self.store, StoreConfig):
            raise ConfigError(
                f"store must be a repro_torch.core.StoreConfig, got {type(self.store).__name__}"
            )
        if self.store.lifetime is not None and self.store.mode != "parallax":
            raise ConfigError(
                f"store.lifetime requires mode 'parallax' (lifetime-aware "
                f"placement splits the hybrid layout's value log), got "
                f"mode {self.store.mode!r}"
            )
        self.partitioning.validate()
        self.execution.validate()
        if self.batch_size is not None and self.batch_size < 0:
            raise ConfigError(f"batch_size must be >= 0, got {self.batch_size}")
        if self.execution.mode == "async" and self.batch_size == 0:
            raise ConfigError(
                "async execution needs batch_size >= 1 "
                "(per-op dispatch is serial-only); leave batch_size=None for auto"
            )
        if self.gc_every < 0:
            raise ConfigError(f"gc_every must be >= 0, got {self.gc_every}")
        if self.snapshot_dir is not None and not isinstance(self.snapshot_dir, str):
            raise ConfigError(
                f"snapshot_dir must be a path string or None, "
                f"got {type(self.snapshot_dir).__name__}"
            )
        return self

    def default_batch_size(self) -> int:
        if self.batch_size is not None:
            return self.batch_size
        if self.execution.mode == "serial" and self.partitioning.scheme == "none":
            return 0  # the legacy bare-store per-op path
        return 64

    def tag(self) -> str:
        """Compact engine-config id carried in benchmark row ids
        (``scripts/check_bench.py`` keys baseline rows on it)."""
        return f"{self.partitioning.tag()}+{self.execution.tag()}"


# --------------------------------------------------------------------- writes
class WriteBatch:
    """Buffered writes, applied as one unit at a sequence point.

    Collect with :meth:`put` / :meth:`update` / :meth:`delete` (chainable),
    then apply with :meth:`Engine.write` — or use the batch as a context
    manager, which commits on clean exit and discards on exception.  Ops
    apply in insertion order; consecutive same-kind runs dispatch through the
    back-end's batched APIs (the policy hook fires once per run, exactly like
    the legacy ``put_many``/``update_many``/``delete_many`` call patterns
    this class replaces).  On an async engine the whole batch is drained
    before :meth:`Engine.write` returns, so its effects are visible to the
    caller.  A committed batch is cleared and may be refilled.
    """

    __slots__ = ("_engine", "_ops")

    def __init__(self, engine: "Engine"):
        self._engine = engine
        self._ops: list[tuple[str, bytes, bytes]] = []

    def put(self, key: bytes, value: bytes) -> "WriteBatch":
        self._ops.append(("put", key, value))
        return self

    def update(self, key: bytes, value: bytes) -> "WriteBatch":
        self._ops.append(("update", key, value))
        return self

    def delete(self, key: bytes) -> "WriteBatch":
        self._ops.append(("delete", key, b""))
        return self

    def clear(self) -> None:
        self._ops.clear()

    def __len__(self) -> int:
        return len(self._ops)

    def __enter__(self) -> "WriteBatch":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self._engine.write(self)
        else:
            self.clear()  # discard: an aborted batch must not commit on reuse


def _op_runs(ops: list[tuple[str, bytes, bytes]]):
    """Maximal consecutive same-kind runs, in insertion order."""
    run_kind: str | None = None
    run: list[tuple[bytes, bytes]] = []
    for kind, key, value in ops:
        if run_kind is not None and kind != run_kind:
            yield run_kind, run
            run = []
        run_kind = kind
        run.append((key, value))
    if run_kind is not None:
        yield run_kind, run


# ------------------------------------------------------------------ iterator
class Iterator:
    """Lazy RocksDB-style cursor over the engine's sorted live rows.

    ``seek(key)`` positions at the first row ``>= key``; ``valid()`` says
    whether the cursor is on a row; ``key()``/``value()`` read it; ``next()``
    advances.  Rows are produced on demand from the back-end's lazy stream
    (:meth:`ParallaxStore.iter_range` / the front-ends' ``iter_rows``) —
    the range back-end streams shard-by-shard, the hash back-end k-way merges
    incrementally — so rows never visited are never read or charged, unlike
    the eager ``scan(start, count)`` this replaces.

    Creating or re-seeking the iterator is a sequence point on an async
    engine (the pipeline drains first).  The cursor is *unpinned*: writing
    through the engine, or a topology change (rebalance/migration tick),
    invalidates it — re-``seek`` after mutating.  Reading an invalid position
    raises :class:`EngineError`.
    """

    __slots__ = ("_engine", "_rows", "_key", "_value", "_valid")

    def __init__(self, engine: "Engine", start: bytes = b""):
        self._engine = engine
        self._rows: _TypingIterator[tuple[bytes, bytes]] = iter(())
        self._key: bytes | None = None
        self._value: bytes | None = None
        self._valid = False
        self.seek(start)

    def seek(self, key: bytes) -> "Iterator":
        """Position at the first live row with ``row_key >= key``."""
        eng = self._engine
        eng._check_open()
        eng._drain()
        store = eng._store
        if isinstance(store, ParallaxStore):
            self._rows = store.iter_range(key)
        else:
            self._rows = store.iter_rows(key)
        self._advance()
        return self

    def seek_to_first(self) -> "Iterator":
        return self.seek(b"")

    def _advance(self) -> None:
        nxt = next(self._rows, None)
        if nxt is None:
            self._valid, self._key, self._value = False, None, None
        else:
            self._valid = True
            self._key, self._value = nxt

    def valid(self) -> bool:
        return self._valid

    def key(self) -> bytes:
        self._require_valid()
        return self._key  # type: ignore[return-value]

    def value(self) -> bytes:
        self._require_valid()
        return self._value  # type: ignore[return-value]

    def next(self) -> None:
        self._require_valid()
        self._advance()

    def _require_valid(self) -> None:
        if not self._valid:
            raise EngineError(
                "iterator is not positioned on a row (exhausted or never sought; "
                "check valid() / seek first)"
            )

    def __iter__(self) -> _TypingIterator[tuple[bytes, bytes]]:
        """Consume from the current position as ``(key, value)`` pairs.

        The cursor advances on resumption, not ahead of it: a consumer that
        stops early (``itertools.islice``, ``break``) leaves the cursor
        positioned on the last yielded row and never pays for a lookahead
        row — pulling ``k`` rows charges exactly ``k`` rows.
        """
        while self._valid:
            yield (self._key, self._value)  # type: ignore[misc]
            self._advance()


def _debug_checks_env() -> bool:
    """Fleet-wide race-detector switch: any value of ``REPRO_DEBUG_CHECKS``
    other than empty / ``0`` / ``false`` / ``off`` enables it (CI's nightly
    slow sweep exports ``REPRO_DEBUG_CHECKS=1``)."""
    return os.environ.get("REPRO_DEBUG_CHECKS", "").strip().lower() not in (
        "", "0", "false", "off")


# -------------------------------------------------------------------- engine
class Engine:
    """A uniform KV surface over any partitioning × execution combination.

    Built by :func:`open`; do not construct front-ends directly in new code.
    All operations raise :class:`ClosedError` after :meth:`close`.  See the
    module docstring for the surface and ``docs/api.md`` for the config tree
    and the old→new migration table.
    """

    def __init__(self, config: EngineConfig):
        config.validate()
        self.config = config
        self._closed = False
        self._snapshot_seq = 0
        self._store = self._build_store(config)
        self._executor: ShardExecutor | None = None
        if config.execution.mode == "async":
            e = config.execution
            self._executor = ShardExecutor(
                self._store, e.workers, pipeline=e.pipeline, pace=e.pace,
                max_pending=e.max_pending,
            )
        # the race detector is opt-in and imported lazily: with debug checks
        # off, nothing of repro_torch.analysis ever loads (zero-overhead contract,
        # held by tests/test_analysis_racecheck.py)
        self.race_checker = None
        self.protocol_monitor = None
        if config.debug_checks or _debug_checks_env():
            from repro_torch.analysis.racecheck import attach_engine
            from repro_torch.analysis.protocol.monitor import (
                attach_engine as attach_protocol_monitor,
            )

            self.race_checker = attach_engine(self)
            self.protocol_monitor = attach_protocol_monitor(self)

    @staticmethod
    def _build_store(cfg: EngineConfig):
        p = cfg.partitioning
        store_cfg = dataclasses.replace(cfg.store)
        if p.scheme == "none":
            if cfg.execution.mode == "serial":
                return ParallaxStore(store_cfg)
            # the executor needs the batched front-end plumbing; a 1-shard
            # hash store is op-for-op identical to the bare store
            return ShardedStore(1, store_cfg)
        if p.scheme == "hash":
            return ShardedStore(p.shards, store_cfg,
                                migration_batch_keys=p.migration_batch_keys,
                                rescale_budget=p.rescale_budget)
        kw = dict(
            rebalance_window=p.rebalance_window, split_factor=p.split_factor,
            merge_factor=p.merge_factor, min_split_keys=p.min_split_keys,
            max_shards=p.max_shards, auto_rebalance=p.auto_rebalance,
            migration_batch_keys=p.migration_batch_keys,
            rescale_budget=p.rescale_budget,
        )
        if p.boundaries is not None:
            return RangeShardedStore(config=store_cfg, boundaries=list(p.boundaries), **kw)
        return RangeShardedStore(p.shards, store_cfg, **kw)

    # ------------------------------------------------------------- lifecycle
    @property
    def store(self):
        """The backing front-end (escape hatch for maintenance/test surfaces
        the uniform API does not wrap).  With async execution, touch it only
        while no driver call is in flight."""
        return self._store

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, wait: bool = True) -> None:
        """Close the engine (idempotent).  With async execution the executor
        shuts down — draining in-flight work first unless ``wait=False``.
        On a clean close (``wait=True``) of a ``debug_checks`` engine, any
        lockset violation the race detector recorded is raised as
        :class:`~repro_torch.analysis.racecheck.RaceViolation`."""
        if self._closed:
            return
        self._closed = True
        if self._executor is not None:
            self._executor.close(wait=wait)
        if wait and self.race_checker is not None:
            self.race_checker.raise_if_violations()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(wait=exc_type is None)

    def _check_open(self) -> None:
        if self._closed:
            raise ClosedError("engine is closed")

    # contract: coordinator-only
    def _drain(self) -> None:
        if self._executor is not None:
            self._executor.drain()

    # contract: coordinator-only
    def _sequence(self, fn):
        """Run ``fn`` with nothing in flight (coordinator-only)."""
        if self._executor is None:
            return fn()
        return self._executor.exclusive(fn)

    # ------------------------------------------------------------- point ops
    def put(self, key: bytes, value: bytes) -> None:
        self._check_open()
        if self._executor is None:
            self._store.put(key, value)
        else:
            self._executor.put_many([(key, value)])

    def update(self, key: bytes, value: bytes) -> None:
        self._check_open()
        if self._executor is None:
            self._store.update(key, value)
        else:
            self._executor.update_many([(key, value)])

    def delete(self, key: bytes) -> None:
        self._check_open()
        if self._executor is None:
            self._store.delete(key)
        else:
            self._executor.delete_many([key])

    def get(self, key: bytes) -> bytes | None:
        self._check_open()
        if self._executor is None:
            return self._store.get(key)
        return self._executor.get_many([key]).result()[0]

    # ---------------------------------------------------------------- writes
    def write_batch(self) -> WriteBatch:
        self._check_open()
        return WriteBatch(self)

    def write(self, batch: WriteBatch) -> None:
        """Apply a :class:`WriteBatch` (see its docstring for semantics)."""
        self._check_open()
        store, ex = self._store, self._executor
        for kind, items in _op_runs(batch._ops):
            if kind == "put":
                if ex is not None:
                    ex.put_many(items)
                    ex.after_batch()
                elif hasattr(store, "put_many"):
                    store.put_many(items)
                else:
                    for k, v in items:
                        store.put(k, v)
            elif kind == "update":
                if ex is not None:
                    ex.update_many(items)
                    ex.after_batch()
                elif hasattr(store, "update_many"):
                    store.update_many(items)
                else:
                    for k, v in items:
                        store.update(k, v)
            else:
                keys = [k for k, _ in items]
                if ex is not None:
                    ex.delete_many(keys)
                    ex.after_batch()
                elif hasattr(store, "delete_many"):
                    store.delete_many(keys)
                else:
                    for k in keys:
                        store.delete(k)
        self._drain()
        batch.clear()

    # ----------------------------------------------------------------- reads
    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        """Eager sorted scan (the legacy surface; prefer :meth:`iterator`)."""
        self._check_open()
        return self._sequence(lambda: self._store.scan(start, count))

    def iterator(self, start: bytes = b"") -> Iterator:
        """A lazy cursor positioned at the first row ``>= start``."""
        self._check_open()
        return Iterator(self, start)

    # ----------------------------------------------------------- maintenance
    def gc_tick(self, force: bool = False):
        """Value-log GC tick (per-shard background tasks on an async hash
        engine — returns ``None`` there; the segment count otherwise)."""
        self._check_open()
        if self._executor is None:
            return self._store.gc_tick(force=force)
        return self._executor.gc_tick(force=force)

    def migration_tick(self, budget: int | None = None) -> int:
        """Advance in-flight migrations — a range rebalance leg or any
        scheme's rescale legs (no-op on a bare store)."""
        self._check_open()
        if self._executor is not None:
            return self._executor.migration_tick(budget)
        tick = getattr(self._store, "migration_tick", None)
        return tick(budget) if tick is not None else 0

    def rescale(self, shards: int, *, budget: int | None = None) -> dict:
        """Start an online rescale of the fleet to ``shards`` shards.

        Plans a minimal-movement remap (hash: mod-routing compatible sizes
        only — a multiple or divisor of the current count; range:
        quantile-driven boundary re-splits), journals it to the shard
        metadata WAL, and flips routing immediately: reads and writes keep
        serving while the legs drain in the background via
        :meth:`migration_tick` (driver-paced; ``repro_torch.api.execute`` paces it
        for you).  ``budget`` caps device bytes per tick across *all*
        concurrent legs (default ``partitioning.rescale_budget``; 0 =
        unthrottled).  Returns :meth:`topology`.  Raises
        :class:`ConfigError` on a non-sharded engine, a non-positive or
        unreachable shard count, or a rescale already in flight.
        """
        self._check_open()
        if self.config.partitioning.scheme == "none":
            raise ConfigError(
                "rescale() needs a sharded engine; partitioning 'none' is a "
                "single store — open with 'hash:N' or 'range:N'"
            )
        if shards < 1:
            raise ConfigError(
                f"rescale() needs a positive shard count, got {shards}"
            )
        try:
            self._sequence(lambda: self._store.rescale(shards, budget=budget))
        except ValueError as e:
            raise ConfigError(str(e)) from None
        return self.topology()

    def topology(self) -> dict:
        """The fleet shape: ``scheme``, ``shards``, range ``boundaries``
        (``None`` elsewhere), and ``rescale`` — in-flight rescale progress
        counters, or ``None`` when the fleet is quiescent.  Usable after
        :meth:`close` (post-run reporting)."""
        if not self._closed:
            self._drain()
        store = self._store
        if isinstance(store, ParallaxStore):
            return {"scheme": "none", "shards": 1, "boundaries": None,
                    "rescale": None}
        return {
            "scheme": self.config.partitioning.scheme,
            "shards": store.num_shards,
            "boundaries": (list(store.boundaries)
                           if isinstance(store, RangeShardedStore) else None),
            "rescale": store.rescale_progress(),
        }

    def flush_all(self) -> None:
        self._check_open()
        self._sequence(self._store.flush_all)

    def crash(self):
        """Drop volatile state at a sequence point (test hook); returns the
        recovery cutoff (per-store list on sharded back-ends)."""
        self._check_open()
        return self._sequence(self._store.crash)

    def recover(self) -> None:
        self._check_open()
        self._sequence(self._store.recover)

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Namespaced counters: ``engine`` (config identity), ``store``
        (aggregate :class:`StoreStats`), ``device`` (aggregate
        :class:`DeviceStats`), plus ``frontend`` (routing counters) on
        sharded back-ends, ``topology`` on the range scheme, and
        ``lifetime`` (sketch state + per-class log/GC counters; per-shard
        under ``"shards"`` on sharded back-ends) when
        ``store.lifetime`` is configured.  Usable after :meth:`close`
        (post-run reporting)."""
        if not self._closed:
            self._drain()
        store = self._store
        out: dict = {
            "engine": {
                "config": self.config.tag(),
                "partitioning": self.config.partitioning.scheme,
                "execution": self.config.execution.mode,
                "closed": self._closed,
            },
        }
        if isinstance(store, ParallaxStore):
            out["store"] = dataclasses.asdict(store.stats)
            out["device"] = dataclasses.asdict(store.device.stats)
            lt = store.lifetime_state()
            if lt is not None:
                out["lifetime"] = lt
            return out
        out["engine"]["num_shards"] = store.num_shards
        out["store"] = dataclasses.asdict(store.aggregate_stats())
        out["device"] = dataclasses.asdict(store.device_stats())
        lts = store.lifetime_states()
        if lts is not None:
            out["lifetime"] = {"shards": lts}
        out["frontend"] = {
            "scans": store.scans, "scan_probes": store.scan_probes,
            "gets": store.gets, "get_probes": store.get_probes,
        }
        if isinstance(store, RangeShardedStore):
            r = store.rescale_progress()
            m = store.migration if r is None else None
            out["topology"] = {
                "boundaries": list(store.boundaries),
                "splits": store.splits, "merges": store.merges,
                "migrated_keys": store.migrated_keys,
                "migration_ticks": store.migration_ticks,
                "get_fallbacks": store.get_fallbacks,
                "migration": None if m is None else dataclasses.asdict(m),
                "rescale": r,
                "meta_records": store.metalog.n_records,
                "meta_bytes": store.metalog.bytes_appended,
            }
        return out

    def device_time(self, policy: str | None = None) -> float:
        """Modeled completion time of the engine's device traffic under an
        overlap policy (default: the config's ``execution.overlap``)."""
        if not self._closed:
            self._drain()  # like stats(): never read counters mid-flight
        if isinstance(self._store, ParallaxStore):
            return self._store.device.device_time()
        return self._store.device_time(policy or self.config.execution.overlap)

    def amplification(self) -> float:
        if not self._closed:
            self._drain()
        return self._store.amplification()

    def space_bytes(self) -> int:
        if not self._closed:
            self._drain()
        return self._store.space_bytes()

    # ------------------------------------------------------------- snapshots
    def snapshot(self, path: str | None = None) -> str:
        """Write a restartable snapshot manifest and return its path.

        The manifest is a JSON document (``format`` 1) holding the engine's
        config and full logical state — every live row with its LSN, plus
        range topology and any in-flight migration — captured at a sequence
        point and published atomically (write-temp/fsync/rename; a crash
        mid-snapshot leaves the previous manifest intact).  On a
        range-partitioned engine the capture also appends a ``snapshot``
        record to the shard-metadata WAL and, when
        ``config.truncate_on_snapshot`` (the default), truncates the WAL
        down to that record so recovery replays O(delta) records.

        ``path`` defaults to ``snapshot-<n>.json`` under
        ``config.snapshot_dir``; with neither set this raises
        :class:`ConfigError`.  Load with :meth:`restore` (into a live,
        compatible engine) or module-level :func:`restore` (a fresh engine).
        """
        self._check_open()
        if path is None:
            if self.config.snapshot_dir is None:
                raise ConfigError(
                    "snapshot() needs a destination: pass a path or set "
                    "EngineConfig.snapshot_dir"
                )
            os.makedirs(self.config.snapshot_dir, exist_ok=True)
            path = os.path.join(
                self.config.snapshot_dir, f"snapshot-{self._snapshot_seq}.json"
            )
            self._snapshot_seq += 1
        state = self._sequence(self._capture_state)
        doc = {
            "format": 1,
            "config": _jsonable(dataclasses.asdict(self.config)),
            "state": _jsonable(state),
        }
        atomic_write_bytes(path, json.dumps(doc).encode("utf-8"))
        return path

    def restore(self, path: str) -> None:
        """Replace this engine's contents with a snapshot manifest's state.

        The snapshot's partitioning scheme must be compatible with this
        engine's (``range`` only restores into ``range``; a bare store and a
        1-shard hash fleet interconvert) — :class:`ConfigError` otherwise.
        Restoring re-roots a range engine's metadata WAL at a fresh snapshot
        record.  To restore into a *new* engine, use module-level
        :func:`restore`.
        """
        self._check_open()
        with io.open(path, "rb") as f:
            doc = json.loads(f.read())
        if doc.get("format") != 1:
            raise ConfigError(
                f"unsupported snapshot format {doc.get('format')!r} in {path}"
            )
        state = _from_jsonable(doc["state"])
        self._sequence(lambda: self._install_state(state))

    def clone(self, **overrides) -> "Engine":
        """Open an independent engine with this engine's current contents.

        State is captured in memory at a sequence point (no file is
        written) and installed into a fresh engine built from this config
        plus ``overrides`` — any :class:`EngineConfig` field except
        ``partitioning``, which the captured state is keyed to
        (:class:`ConfigError`; snapshot and reload a fresh fleet to
        repartition).  The clone shares nothing with the source: subsequent
        writes on either side are invisible to the other.
        """
        self._check_open()
        if "partitioning" in overrides:
            raise ConfigError(
                "clone() cannot change partitioning: the captured state is "
                "keyed to the source scheme — snapshot() and open a fresh "
                "engine instead"
            )
        state = self._sequence(self._capture_state)
        eng = Engine(
            dataclasses.replace(self.config, **overrides) if overrides else self.config
        )
        try:
            eng._sequence(lambda: eng._install_state(state))
        except BaseException:
            eng.close(wait=False)
            raise
        return eng

    # contract: coordinator-only
    def _capture_state(self) -> dict:
        """Capture full logical state (call at a sequence point only)."""
        store = self._store
        if isinstance(store, RangeShardedStore):
            store.snapshot_metadata(truncate=self.config.truncate_on_snapshot)
            return store.state_snapshot()
        if isinstance(store, ParallaxStore):
            return {"kind": "bare", "rows": store.snapshot_rows(), "lsn": store.lsn}
        return store.state_snapshot()

    # contract: coordinator-only
    def _install_state(self, state: dict) -> None:
        """Replace store contents with a captured state (sequence point only)."""
        store, kind = self._store, state.get("kind")
        if isinstance(store, RangeShardedStore):
            if kind != "range":
                raise ConfigError(
                    f"cannot restore a {kind!r} snapshot into a "
                    f"range-partitioned engine"
                )
            store.load_state(state)
            return
        if isinstance(store, ParallaxStore):
            # a 1-shard hash capture is op-for-op a bare store
            if kind == "hash" and len(state["shards"]) == 1:
                snap = state["shards"][0]
                state = {"kind": "bare", "rows": snap["rows"], "lsn": snap["lsn"]}
                kind = "bare"
            if kind != "bare":
                raise ConfigError(
                    f"cannot restore a {kind!r} snapshot into an unpartitioned "
                    f"serial engine"
                )
            fresh = ParallaxStore(dataclasses.replace(self.config.store))
            fresh.load_rows(state["rows"], state["lsn"])
            self._store = fresh
            return
        # hash fleet (including the 1-shard wrapper behind scheme 'none'+async)
        if kind == "bare":
            state = {"kind": "hash",
                     "shards": [{"rows": state["rows"], "lsn": state["lsn"]}]}
            kind = "hash"
        if kind != "hash":
            raise ConfigError(
                f"cannot restore a {kind!r} snapshot into a hash-partitioned engine"
            )
        try:
            store.load_state(state)
        except ValueError as e:
            raise ConfigError(str(e)) from None


# ------------------------------------------------------- snapshot (de)coding
def _jsonable(obj):
    """Recursively JSON-encode captured state: ``bytes`` become
    ``{"__bytes__": <hex>}`` and tuples become lists (state dicts only ever
    use ``str`` keys, so the bytes marker cannot collide with a real key)."""
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    return obj


def _from_jsonable(obj):
    if isinstance(obj, dict):
        if set(obj) == {"__bytes__"}:
            return bytes.fromhex(obj["__bytes__"])
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    return obj


def _config_from_jsonable(d: dict) -> EngineConfig:
    """Rebuild an :class:`EngineConfig` from a decoded snapshot manifest."""
    part = dict(d["partitioning"])
    if part.get("boundaries") is not None:
        part["boundaries"] = tuple(part["boundaries"])
    store = dict(d["store"])
    if store.get("lifetime") is not None:
        store["lifetime"] = LifetimeConfig(**store["lifetime"])
    return EngineConfig(
        store=StoreConfig(**store),
        partitioning=PartitioningConfig(**part),
        execution=ExecutionConfig(**d["execution"]),
        **{k: d[k] for k in ("batch_size", "gc_every", "debug_checks",
                             "snapshot_dir", "truncate_on_snapshot")},
    )


# -------------------------------------------------------------------- driver
def open(config: EngineConfig | None = None, **overrides) -> Engine:
    """Open an :class:`Engine` from a declarative :class:`EngineConfig`.

    Field overrides may be passed as keywords, with or without a base config:
    ``open(partitioning="hash:4", execution="async")``.  Raises
    :class:`ConfigError` on any invalid combination.
    """
    if config is None:
        config = EngineConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    if not isinstance(config, EngineConfig):
        raise ConfigError(
            f"open() takes an EngineConfig (or field overrides), got {type(config).__name__}"
        )
    return Engine(config)


def restore(path: str, **overrides) -> Engine:
    """Open a fresh :class:`Engine` from a snapshot manifest.

    The engine is built from the config recorded in the manifest, with
    keyword ``overrides`` applied on top — any :class:`EngineConfig` field
    except ``partitioning``, which the snapshot state is keyed to
    (:class:`ConfigError`).  The state then installs exactly as
    :meth:`Engine.restore` would.
    """
    if "partitioning" in overrides:
        raise ConfigError(
            "restore() cannot change partitioning: the snapshot state is "
            "keyed to the source scheme"
        )
    with io.open(path, "rb") as f:
        doc = json.loads(f.read())
    if doc.get("format") != 1:
        raise ConfigError(
            f"unsupported snapshot format {doc.get('format')!r} in {path}"
        )
    cfg = _config_from_jsonable(_from_jsonable(doc["config"]))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    eng = Engine(cfg)
    try:
        state = _from_jsonable(doc["state"])
        eng._sequence(lambda: eng._install_state(state))
    except BaseException:
        eng.close(wait=False)
        raise
    return eng


def execute(engine: Engine, ops, *, batch_size: int | None = None,
            gc_every: int | None = None, migrate_budget: int | None = None) -> dict:
    """The one YCSB op-stream driver; returns op counts.

    Replaces ``repro_torch.core.ycsb.execute`` *and* ``execute_async``: the
    engine's :class:`ExecutionConfig` decides which path runs, with the
    batching/tick/GC positions of both guaranteed identical by the shared
    batch schedule (``ycsb._batch_events``).  Overrides default to the
    engine config's ``batch_size`` / ``gc_every`` /
    ``partitioning.migrate_budget``.
    """
    if not isinstance(engine, Engine):
        raise TypeError(
            "repro_torch.api.execute drives an Engine; open one with "
            "repro_torch.api.open(EngineConfig(...)) — the legacy store drivers "
            "live on as deprecated shims in repro_torch.core.ycsb"
        )
    engine._check_open()
    cfg = engine.config
    bs = cfg.default_batch_size() if batch_size is None else batch_size
    ge = cfg.gc_every if gc_every is None else gc_every
    mb = cfg.partitioning.migrate_budget if migrate_budget is None else migrate_budget
    if engine._executor is None:
        return _ycsb._execute(engine.store, ops, gc_every=ge, batch_size=bs,
                              migrate_budget=mb)
    if bs < 1:
        raise ConfigError(
            "async execution needs batch_size >= 1 (per-op dispatch is serial-only)"
        )
    return _ycsb._execute_async(engine.store, ops, batch_size=bs, gc_every=ge,
                                migrate_budget=mb, executor=engine._executor)


def reset_deprecation_warnings() -> None:
    """Forget which deprecated shims have warned (the warn-once registry is
    per-process; tests reset it to observe the first-call warning)."""
    _ycsb._DEPRECATED_WARNED.clear()


__all__ = [
    "ClosedError",
    "ConfigError",
    "Engine",
    "EngineConfig",
    "EngineError",
    "ExecutionConfig",
    "Iterator",
    "PartitioningConfig",
    "WriteBatch",
    "execute",
    "open",
    "reset_deprecation_warnings",
    "restore",
]
