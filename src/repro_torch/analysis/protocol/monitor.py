"""Runtime WAL-protocol monitor: the automaton replayed over live streams.

Behind ``EngineConfig(debug_checks=True)`` (or ``REPRO_DEBUG_CHECKS``), a
:class:`ProtocolMonitor` is attached to the engine's shard-metadata WAL and
validates every record against :data:`~.spec.WAL_SPEC` as it is appended —
payload schema, the ordering automaton refined with concrete leg tracking
(which rescale leg a ``checkpoint``/``finish`` names, whether
``rescale_finish`` really closes a drained rescale), and the live
flush-before-append fence (the destination store's logs must hold zero
unflushed bytes at the instant a ``checkpoint``/``finish``/``gc_reclaim``/
``snapshot`` record commits).  Recovery replay is validated too: the monitor
wraps ``MetadataLog.replay`` and re-runs the full durable stream through a
fresh automaton, so a corrupted or reordered stream fails at recovery, not
at the next silent divergence.

A violation raises :class:`ProtocolViolation` carrying the offending record
*window* (the last few records plus the offender) so CI logs show the
context, not just the symptom.

Zero-overhead-off discipline (mirrors :mod:`repro.analysis.racecheck`): this
module is imported only from the ``debug_checks`` branch of
``Engine.__init__``; all instrumentation is per-instance method shims, so
with checks off nothing here loads and results/stats are byte-identical —
held by a subprocess-pinned test in ``tests/test_protocol_monitor.py``.
"""
from __future__ import annotations

import collections

from .spec import FLUSH_BEFORE_APPEND, ProtocolSpec, WAL_SPEC

#: per-store value/WAL logs whose unflushed bytes the live fence inspects
_STORE_LOGS = ("small_log", "medium_log", "large_log", "short_log")


class ProtocolViolation(RuntimeError):
    """A WAL record stream diverged from the protocol spec.

    ``window`` holds the trailing records up to and including the offender;
    ``record`` is the offender itself.
    """

    def __init__(self, message: str, window, record):
        self.window = list(window)
        self.record = record
        tail = "".join(f"\n    [{i - len(self.window) + 1:+d}] {r!r}"
                       for i, r in enumerate(self.window))
        super().__init__(f"{message}; offending record window (offender last):"
                         f"{tail}")


def store_is_clean(store) -> bool:
    """Every log of a backing store group-committed (no unflushed bytes)."""
    for name in _STORE_LOGS:
        log = getattr(store, name, None)
        if log is not None and getattr(log, "_unflushed", 0):
            return False
    return True


class ProtocolMonitor:
    """Stream validator for one metadata WAL.

    Call :meth:`observe` per appended record (``live=True`` enables the
    flush-fence, which needs the attached store fleet), or
    :meth:`validate_stream` over a full durable stream.  State is concrete:
    the in-flight legacy leg or rescale leg set is tracked from record
    payloads, exactly mirroring what recovery replay would reconstruct.
    """

    def __init__(self, spec: ProtocolSpec = WAL_SPEC, store_resolver=None,
                 window: int = 6):
        self.spec = spec
        self._resolver = store_resolver
        self._window = collections.deque(maxlen=window)
        self.records_checked = 0
        self.replays_checked = 0
        self.reset()

    def reset(self) -> None:
        self._started = False
        self._legacy = None    # dst ref of the single legacy split/merge leg
        self._rescale = None   # {"scheme": str, "legs": {leg_id: dst_ref}}
        self._window.clear()

    # ----------------------------------------------------------------- errors
    def _fail(self, message: str, record) -> None:
        raise ProtocolViolation(message, self._window, record)

    # ---------------------------------------------------------------- observe
    def observe(self, record, *, live: bool = False) -> None:
        self._window.append(record)
        self.records_checked += 1
        kind_name = record.get("kind") if isinstance(record, dict) else None
        if not isinstance(kind_name, str) or kind_name not in self.spec:
            self._fail(f"record kind {kind_name!r} is not declared in the "
                       f"{self.spec.name} spec", record)
        kind = self.spec[kind_name]
        keys = frozenset(record)
        missing = kind.required - keys
        unknown = keys - kind.payload_keys
        if missing or unknown:
            self._fail(
                f"{kind_name} payload mismatch: missing {sorted(missing)}, "
                f"undeclared {sorted(unknown)}", record)
        if not self._started:
            if not kind.stream_start:
                self._fail(f"{kind_name} cannot open a WAL stream (only "
                           f"{sorted(self.spec.stream_start_kinds())} can)",
                           record)
            self._started = True
        elif kind_name == "init":
            self._fail("init record mid-stream: genesis may only be the "
                       "first record", record)
        dst_ref = getattr(self, f"_on_{kind_name}")(record)
        if live and self._resolver is not None \
                and FLUSH_BEFORE_APPEND in kind.fences:
            for store in self._resolver(kind_name, record, dst_ref):
                if not store_is_clean(store):
                    self._fail(
                        f"flush-before-append fence broken: {kind_name} "
                        "committed while the covered store still holds "
                        "unflushed log bytes — a crash now would lose data "
                        "the durable record already points at", record)

    def validate_stream(self, records) -> int:
        """Run a full stream (e.g. ``metalog.replay()``) from a fresh state;
        returns the number of records validated."""
        self.reset()
        n = 0
        for rec in records:
            self.observe(rec, live=False)
            n += 1
        return n

    # ----------------------------------------------------- per-kind handlers
    def _on_init(self, record):
        return None

    def _on_snapshot(self, record):
        # a snapshot is a full-state reset: adopt its topology authoritatively
        # (this is exactly what recovery replay does with it)
        m = record.get("migration")
        self._legacy = None if m is None else m["dst_id"]
        r = record.get("rescale")
        if r is None:
            self._rescale = None
        else:
            if self._legacy is not None:
                self._fail("snapshot carries both a legacy migration and a "
                           "rescale: the coordinator never runs both", record)
            self._rescale = {
                "scheme": "range",
                "legs": {leg["dst_id"]: leg["dst_id"] for leg in r["legs"]},
            }
        return None

    def _on_cutoff(self, record):
        return None

    def _on_gc_reclaim(self, record):
        return None

    def _start_leg(self, record):
        if self._legacy is not None:
            self._fail(f"{record['kind']} while a legacy migration leg is "
                       "already in flight (the coordinator drains first)",
                       record)
        if self._rescale is not None:
            self._fail(f"{record['kind']} while a rescale is in flight "
                       "(legacy legs and rescales are mutually exclusive)",
                       record)
        self._legacy = record["dst"]
        return None

    _on_split_start = _start_leg
    _on_merge_start = _start_leg

    def _on_rescale_start(self, record):
        if self._legacy is not None or self._rescale is not None:
            self._fail("rescale_start while a migration is already in flight",
                       record)
        scheme, legs = record.get("scheme"), record.get("legs")
        leg_map = {}
        try:
            if scheme == "range":
                # rows: [kind, src, dst, lo, hi, epoch] — legs keyed by dst id
                leg_map = {row[2]: row[2] for row in legs}
            elif scheme == "hash":
                # rows: [src, dst, epoch] — legs keyed by leg index
                leg_map = {i: row[1] for i, row in enumerate(legs)}
            else:
                self._fail(f"rescale_start with unknown scheme {scheme!r}",
                           record)
        except (TypeError, IndexError):
            self._fail(f"rescale_start with malformed legs {legs!r}", record)
        self._rescale = {"scheme": scheme, "legs": leg_map}
        return None

    def _resolve_leg(self, record):
        if "leg" in record:
            if self._rescale is None:
                self._fail(f"{record['kind']} names rescale leg "
                           f"{record['leg']!r} but no rescale is in flight",
                           record)
            legs = self._rescale["legs"]
            if record["leg"] not in legs:
                self._fail(
                    f"{record['kind']} names leg {record['leg']!r} which is "
                    f"not active (active: {sorted(legs)})", record)
            return record["leg"], legs[record["leg"]]
        if self._legacy is None:
            self._fail(f"{record['kind']} with no migration leg in flight",
                       record)
        return None, self._legacy

    def _on_checkpoint(self, record):
        _leg, dst_ref = self._resolve_leg(record)
        return dst_ref

    def _on_finish(self, record):
        leg, dst_ref = self._resolve_leg(record)
        if leg is None:
            self._legacy = None
        else:
            del self._rescale["legs"][leg]
        return dst_ref

    def _on_rescale_finish(self, record):
        if self._rescale is None:
            self._fail("rescale_finish with no rescale in flight", record)
        if self._rescale["legs"]:
            self._fail(
                f"rescale_finish with {len(self._rescale['legs'])} leg(s) "
                f"still active ({sorted(self._rescale['legs'])})", record)
        self._rescale = None
        return None


# -------------------------------------------------------------- instrumentation
def _make_resolver(store):
    """Map a fenced record to the backing store(s) that must be clean."""

    def resolve(kind: str, record, dst_ref):
        if kind == "snapshot":
            return list(store._all_stores())
        by_id = getattr(store, "_by_id", None)
        if kind == "gc_reclaim":
            if by_id is None:
                return []
            s = by_id.get(record.get("shard"))
            return [] if s is None else [s]
        if kind in ("checkpoint", "finish") and dst_ref is not None:
            if by_id is not None:  # range: dst_ref is a registry shard id
                s = by_id.get(dst_ref)
                return [] if s is None else [s]
            shards = getattr(store, "shards", None)  # hash: a slot index
            if (shards is not None and isinstance(dst_ref, int)
                    and 0 <= dst_ref < len(shards)):
                return [shards[dst_ref]]
        return []

    return resolve


def _wrap_metalog(metalog, monitor: ProtocolMonitor) -> None:
    """Per-instance shims (racecheck idiom): validate the already-durable
    stream, then check each future append and each recovery replay."""
    monitor.validate_stream(metalog.replay())
    orig_append = metalog.append
    orig_replay = metalog.replay

    def checked_append(record):
        # the crash-injection / single-writer paths raise *inside* the real
        # append, before the record is durable — only committed records are
        # fed to the automaton (exactly the stream recovery would see)
        idx = orig_append(record)
        monitor.observe(record, live=True)
        return idx

    def checked_replay():
        records = orig_replay()
        # recovery-path validation runs the full durable stream through a
        # fresh automaton so it cannot disturb the live monitor's state
        ProtocolMonitor(monitor.spec).validate_stream(records)
        monitor.replays_checked += 1
        return records

    metalog.append = checked_append
    metalog.replay = checked_replay
    metalog._protocol_monitored = True


def attach_store(store, spec: ProtocolSpec = WAL_SPEC):
    """Attach a monitor to a sharded front-end's metadata WAL.

    The range front-end's metalog exists from construction (its ``init``
    record is validated retroactively); the hash front-end creates its
    metalog lazily at the first rescale, so ``_ensure_metalog`` is shimmed
    to wrap the log the moment it exists.  Returns the monitor, or ``None``
    for stores without a metadata WAL (the bare ``ParallaxStore``).
    """
    monitor = ProtocolMonitor(spec, store_resolver=_make_resolver(store))
    metalog = getattr(store, "metalog", None)
    if metalog is not None:
        _wrap_metalog(metalog, monitor)
        return monitor
    if hasattr(store, "_ensure_metalog"):
        orig_ensure = store._ensure_metalog

        def ensure_and_wrap():
            orig_ensure()
            ml = store.metalog
            if ml is not None and not getattr(ml, "_protocol_monitored", False):
                _wrap_metalog(ml, monitor)

        store._ensure_metalog = ensure_and_wrap
        return monitor
    return None


def attach_engine(engine):
    """Attach to an :class:`repro.api.Engine`'s store; returns ``None``
    when the store has no metadata WAL (the bare serial combo)."""
    return attach_store(engine._store)


__all__ = [
    "ProtocolMonitor", "ProtocolViolation", "attach_engine", "attach_store",
    "store_is_clean",
]
