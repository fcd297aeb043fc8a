"""Eraser-style dynamic lockset race detector for the async engine.

The static linter (:mod:`repro_torch.analysis.lint`) proves the *source* honors the
concurrency contracts; this module checks the *execution*: every access to
shared engine state records the set of locks the accessing thread holds, and
the classic Eraser lockset algorithm [Savage et al., SOSP'97] refines a
per-variable candidate set — a write-shared variable whose candidate set goes
empty was reachable by two threads with no common lock, i.e. a data race the
schedule merely happened not to lose.

Adaptation for the executor's barrier discipline: sequence points
(:meth:`ShardExecutor.drain` / ``exclusive``) are happens-before barriers —
the coordinator provably cannot overlap workers across one.  Plain Eraser
would flag the coordinator's unlocked maintenance access after workers
touched the same state (a notorious Eraser false-positive class on
barrier-synchronized code), so :meth:`LocksetChecker.barrier` resets all
variable states when a drain completes; within a barrier window the pure
lockset rule applies.  The single-coordinator submission contract is checked
directly: every executor submission surface records the first submitting
thread and reports any other.

Instrumentation is strictly *per instance* — wrapped locks
(:class:`ChecksafeLock`), bound-method shims on the backing stores, and a
dynamic subclass swap for the front-end counter attributes.  Nothing in this
module is imported, and no wrapper exists on any object, unless
``EngineConfig(debug_checks=True)`` (or ``REPRO_DEBUG_CHECKS=1``) switched it
on — the off path is provably zero-overhead
(``tests/test_analysis_racecheck.py`` counts calls into this file under
``sys.setprofile`` to hold that line).
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.metalog import MetadataLog
from repro_torch.core.shard import BaseShardedStore
from repro_torch.core.store import ParallaxStore

_tls = threading.local()


def _held() -> set:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = set()
    return held


class ChecksafeLock:
    """A ``threading.Lock`` wrapper that tracks itself in the holding thread's
    lockset.  API-compatible with the subset the engine uses (``acquire`` with
    ``blocking``/``timeout``, ``release``, context manager, ``locked``)."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str, lock: threading.Lock | None = None):
        self._lock = lock if lock is not None else threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held().add(self)
        return ok

    def release(self) -> None:
        _held().discard(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "ChecksafeLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<ChecksafeLock {self.name}>"


class RaceViolation(RuntimeError):
    """Raised on clean close of a ``debug_checks`` engine that saw races."""


@dataclasses.dataclass(frozen=True)
class RaceReport:
    """One detected violation (reported once per variable/surface)."""

    var: str
    write: bool
    thread: str
    lockset: tuple[str, ...]
    note: str = ""

    def __str__(self) -> str:
        kind = "write" if self.write else "read"
        locks = ", ".join(self.lockset) or "<empty>"
        return f"{self.var}: unsynchronized {kind} on thread {self.thread} " \
               f"(candidate lockset: {locks}) {self.note}".rstrip()


# Eraser variable states
_EXCLUSIVE, _SHARED, _SHARED_MOD = range(3)


class _VarState:
    __slots__ = ("state", "owner", "candidates")

    def __init__(self, owner: int):
        self.state = _EXCLUSIVE
        self.owner = owner
        self.candidates: set | None = None


class LocksetChecker:
    """The lockset state machine plus the report log.

    ``access(var, write)`` feeds one shared-state access; ``barrier()`` resets
    all variable states at a sequence point; ``check_coordinator(surface)``
    enforces single-coordinator submission.  ``reports`` accumulates one
    :class:`RaceReport` per offending variable; ``events`` counts every access
    observed (tests assert instrumentation actually fired).
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._vars: dict[str, _VarState] = {}
        self._reported: set[str] = set()
        self._coordinator: int | None = None
        self.reports: list[RaceReport] = []
        self.events = 0
        self.barriers = 0

    # ----------------------------------------------------------- the machine
    def access(self, var: str, write: bool) -> None:
        tid = threading.get_ident()
        held = _held()
        with self._mu:
            self.events += 1
            st = self._vars.get(var)
            if st is None:
                self._vars[var] = _VarState(tid)
                return
            if st.state == _EXCLUSIVE:
                if st.owner == tid:
                    return
                # second thread: start refining from its current lockset
                st.state = _SHARED_MOD if write else _SHARED
                st.candidates = set(held)
            else:
                st.candidates &= held
                if write:
                    st.state = _SHARED_MOD
            if st.state == _SHARED_MOD and not st.candidates:
                self._report(var, write, tid,
                             "no common lock across the sharing threads")

    def barrier(self) -> None:
        """A happens-before barrier (executor drain): everything accessed
        before it is ordered before everything after — restart all variables
        at virgin state so cross-window pairs are not reported."""
        with self._mu:
            self.barriers += 1
            self._vars.clear()

    def check_coordinator(self, surface: str) -> None:
        """Record the first thread to submit through ``surface``'s executor
        and report any submission from a different thread."""
        tid = threading.get_ident()
        with self._mu:
            self.events += 1
            if self._coordinator is None:
                self._coordinator = tid
            elif self._coordinator != tid:
                self._report(f"executor.{surface}", True, tid,
                             "second thread submitted to a single-coordinator "
                             "executor")

    def _report(self, var: str, write: bool, tid: int, note: str) -> None:
        # one report per variable: the first empty-lockset access proves the
        # race; repeats on the same variable add noise, not information
        if var in self._reported:
            return
        self._reported.add(var)
        thread = threading.current_thread().name or str(tid)
        st = self._vars.get(var)
        lockset = tuple(sorted(repr(l) for l in (st.candidates or ()))) if st else ()
        self.reports.append(RaceReport(var, write, thread, lockset, note))

    # -------------------------------------------------------------- plumbing
    def wrap_lock(self, lock, name: str) -> ChecksafeLock:
        if isinstance(lock, ChecksafeLock):
            return lock
        return ChecksafeLock(name, lock)

    def raise_if_violations(self) -> None:
        if self.reports:
            lines = "\n  ".join(str(r) for r in self.reports)
            raise RaceViolation(
                f"lockset race detector found {len(self.reports)} violation(s):"
                f"\n  {lines}"
            )


# ------------------------------------------------------------ instrumentation
# front-end counters shared across coordinator + workers (must match the
# static linter's FRONTEND_COUNTERS; the differential tests cross-check)
MONITORED_COUNTERS = frozenset([
    "gets", "get_probes", "get_fallbacks", "scans", "scan_probes",
    "splits", "merges", "migrated_keys", "migration_ticks",
])

# ParallaxStore surfaces touched by executor tasks: method name -> is-write
_STORE_READS = ("get", "scan", "scan_range", "live_keys_in", "newest_entries",
                "index_entry", "iter_range")
_STORE_WRITES = ("put", "update", "delete", "delete_range", "gc_tick",
                 "flush_all", "flush_l0", "crash", "recover", "_write")

_CLASS_CACHE: dict[type, type] = {}


def _instrumented_class(base: type) -> type:
    """A cached dynamic subclass of a front-end class whose attribute hooks
    report counter reads/writes to the instance's ``_race_checker``."""
    cls = _CLASS_CACHE.get(base)
    if cls is not None:
        return cls

    def __setattr__(self, name, value):
        if name in MONITORED_COUNTERS:
            object.__getattribute__(self, "_race_checker").access(
                f"frontend.{name}", True)
        object.__setattr__(self, name, value)

    def __getattribute__(self, name):
        if name in MONITORED_COUNTERS:
            object.__getattribute__(self, "_race_checker").access(
                f"frontend.{name}", False)
        return object.__getattribute__(self, name)

    cls = type(f"Checked{base.__name__}", (base,),
               {"__setattr__": __setattr__, "__getattribute__": __getattribute__})
    _CLASS_CACHE[base] = cls
    return cls


def _wrap_method(obj, name: str, before) -> None:
    """Shadow ``obj.name`` with an instance attribute calling ``before()``
    first — per-instance, so no other object pays anything."""
    orig = getattr(obj, name, None)
    if orig is None:
        return

    def wrapper(*args, __orig=orig, __before=before, **kwargs):
        __before()
        return __orig(*args, **kwargs)

    wrapper.__name__ = getattr(orig, "__name__", name)
    setattr(obj, name, wrapper)


def attach_parallax(store: ParallaxStore, checker: LocksetChecker, label: str) -> None:
    """Report every op on one backing store as an access to one variable —
    the store is single-threaded by the exclusivity contract, so any
    cross-thread overlap without the store's exclusivity lock is a race."""
    if getattr(store, "_race_wrapped", False):
        return
    store._race_wrapped = True
    var = f"store.{label}"
    for name in _STORE_READS:
        _wrap_method(store, name, lambda v=var: checker.access(v, False))
    for name in _STORE_WRITES:
        _wrap_method(store, name, lambda v=var: checker.access(v, True))


def attach_metalog(metalog: MetadataLog, checker: LocksetChecker) -> None:
    """Metadata-WAL appends must be totally ordered (sequence points only):
    modeled as writes to one variable, with the append lock tracked."""
    metalog._append_lock = checker.wrap_lock(metalog._append_lock,
                                             "metalog._append_lock")
    _wrap_method(metalog, "append", lambda: checker.access("metalog.records", True))
    _wrap_method(metalog, "replay", lambda: checker.access("metalog.records", False))


def attach_frontend(store: BaseShardedStore, checker: LocksetChecker) -> None:
    """Instrument a sharded front-end: tracked ``_stats_lock``, counter hooks
    via a dynamic subclass swap, per-shard store shims (including shards a
    later split creates), and the metadata WAL if present."""
    store._race_checker = checker
    store._stats_lock = checker.wrap_lock(store._stats_lock,
                                          "frontend._stats_lock")
    store.__class__ = _instrumented_class(type(store))
    for i, s in enumerate(store._all_stores()):
        attach_parallax(s, checker, str(i))
    metalog = getattr(store, "metalog", None)
    if metalog is not None:
        attach_metalog(metalog, checker)
    orig_new_shard = store._new_shard
    counter = [len(store._all_stores())]

    def _new_shard():
        s = orig_new_shard()
        counter[0] += 1
        attach_parallax(s, checker, f"new{counter[0]}")
        return s

    store._new_shard = _new_shard


_SUBMISSION_SURFACES = ("put_many", "update_many", "delete_many", "get_many",
                        "scan", "after_batch", "migration_tick", "gc_tick",
                        "exclusive")


def attach_executor(executor, checker: LocksetChecker) -> None:
    """Instrument a :class:`ShardExecutor`: exclusivity locks become tracked
    (workers then carry them in their locksets), a completed ``drain`` is a
    lockset barrier, and every submission surface asserts the
    single-coordinator contract."""
    # all future and existing per-store exclusivity locks become tracked
    executor._new_store_lock = lambda: ChecksafeLock("executor.store_lock")
    for key, lock in list(executor._locks.items()):
        executor._locks[key] = checker.wrap_lock(lock, f"executor.store_lock:{key}")
    orig_drain = executor.drain

    def drain():
        orig_drain()
        checker.barrier()

    executor.drain = drain
    for name in _SUBMISSION_SURFACES:
        _wrap_method(executor, name,
                     lambda n=name: checker.check_coordinator(n))


def attach_engine(engine) -> LocksetChecker:
    """Instrument a :class:`repro_torch.api.Engine` (store + executor); returns the
    checker (also reachable as ``engine.race_checker``)."""
    checker = LocksetChecker()
    store = engine.store
    if isinstance(store, BaseShardedStore):
        attach_frontend(store, checker)
    else:
        attach_parallax(store, checker, "solo")
    if engine._executor is not None:
        attach_executor(engine._executor, checker)
    return checker


__all__ = [
    "ChecksafeLock",
    "LocksetChecker",
    "MONITORED_COUNTERS",
    "RaceReport",
    "RaceViolation",
    "attach_engine",
    "attach_executor",
    "attach_frontend",
    "attach_metalog",
    "attach_parallax",
]
