"""Persistent shard-metadata WAL with crash-point fault injection.

PR 2 modeled the range-sharded boundary map as "a tiny WAL'd metadata record"
— an in-memory atomic flip that was asserted, never exercised.  This module
makes it real: every boundary change, shard create/retire, and migration
checkpoint is a :class:`MetadataLog` record, appended through the same
redo-record idiom the store uses (``Log`` append + flush, charged to the
device) and replayed by ``RangeShardedStore.recover()`` to rebuild the
topology — including an in-flight incremental migration, which resumes from
its last durable checkpoint instead of relying on a modeled atomic flip.

Durability model: metadata records are *synchronous* — each ``append`` flushes
before returning (a group commit per record, like the store's redo record),
so a crash never loses an acknowledged record.  The interesting crash windows
are therefore exactly the record *sites*: the instants just before each record
becomes durable, where the protocol has done some data-path work (copies,
flushes, tombstones) that the next record would cover.  The
:meth:`crash_after` hook enumerates them for the fault-injection harness
(``tests/test_crashpoints.py``): with ``crash_after(n)`` armed, the append
that would write record ``n`` (0-based: the ``n+1``-th overall) raises
:class:`CrashPoint` instead — exactly ``n`` records are durable, and the
caller's in-memory state is whatever the protocol had built up to that
un-acknowledged append (the protocol is record-then-apply, so replay of the
``n`` durable records reconstructs a consistent topology).

Record payload bytes are charged to the device with ``kind="meta"`` so the
metadata WAL shows up in amplification stats (``DeviceStats.meta_written``).
"""
from __future__ import annotations

import threading

from .io import Device
from .logs import Log, LogEntry, Pointer
from .lsm import CAT_SMALL


class CrashPoint(RuntimeError):
    """Injected crash at a metadata-WAL record site (see ``crash_after``)."""

    def __init__(self, site: int):
        super().__init__(f"injected crash at metadata-WAL record site {site}")
        self.site = site


def _encode(record: dict) -> bytes:
    """Deterministic record serialization (modeled: size is what matters)."""
    return repr(sorted(record.items())).encode()


class MetadataLog:
    """Append-only, synchronously-committed log of shard-metadata records.

    Records are plain dicts with a ``"kind"`` field; the log keeps them in
    append order for replay and charges their encoded size to the device
    (``kind="meta"``).  ``replay()`` reconstructs from the oldest retained
    record — the ``init`` record at genesis, or a ``snapshot`` record once
    :meth:`truncate` has dropped the prefix it replaces (PR 7): recovery then
    replays O(delta) records instead of O(history).  Truncation is pure
    bookkeeping surgery — dropped records are marked dead in their segments
    and fully-dead non-tail segments are reclaimed; no device traffic is
    charged (``bytes_appended`` stays monotonic, ``log_bytes`` shrinks).

    Background-checkpoint ordering (PR 4): the WAL's correctness rests on
    record order matching protocol-apply order — a ``checkpoint`` committed
    before its batch's destination flush (or two interleaved appends) would
    break the record-then-apply replay.  With the async engine, migration
    ticks run only at executor *sequence points* (no foreground tasks in
    flight), so appends stay totally ordered even when migration runs "in the
    background"; :meth:`append` asserts the single-writer invariant with a
    non-blocking lock and raises on concurrent entry rather than interleave.
    """

    # contract: coordinator-only
    def __init__(self, device: Device):
        self.device = device
        self._log = Log(device, "meta", kind="meta")
        self.records: list[dict] = []
        self._ptrs: list[Pointer] = []  # device slot of each retained record
        self.total_appended = 0  # monotonic: crash sites survive truncation
        self._crash_after: int | None = None
        self._append_lock = threading.Lock()

    @property
    def n_records(self) -> int:
        return len(self.records)

    @property
    def bytes_appended(self) -> int:
        return self._log.appended_bytes

    @property
    def log_bytes(self) -> int:
        """Bytes of retained (non-reclaimed) segments — shrinks on truncate."""
        return self._log.total_bytes

    # ---------------------------------------------------------------- append
    def append(self, record: dict) -> int:
        """Durably append one record; returns its index.

        Raises :class:`CrashPoint` instead of appending when an injected
        crash is armed at this site (``crash_after``) — the record is *not*
        written, modeling a power cut between the protocol action and its
        metadata commit.
        """
        if not self._append_lock.acquire(blocking=False):
            raise RuntimeError(
                f"concurrent MetadataLog.append of kind="
                f"{record.get('kind') if isinstance(record, dict) else record!r}"
                f" at LSN {self.total_appended}: metadata records must be "
                "totally ordered (append only from executor sequence points)"
            )
        try:
            # crash sites count *appends since genesis* (total_appended), not
            # retained records — truncation must not renumber armed sites
            if self._crash_after is not None and self.total_appended >= self._crash_after:
                raise CrashPoint(self.total_appended)
            payload = _encode(record)
            ptr = self._log.append(LogEntry(self.total_appended + 1, b"", payload, CAT_SMALL))
            self._log.flush()  # synchronous commit: an acked record is never lost
            self.records.append(dict(record))
            self._ptrs.append(ptr)
            self.total_appended += 1
            return len(self.records) - 1
        finally:
            self._append_lock.release()

    # -------------------------------------------------------------- truncate
    def truncate(self, upto: int) -> int:
        """Drop the first ``upto`` retained records; returns how many dropped.

        The caller must have made the remaining stream self-contained first —
        i.e. ``records[upto]`` is a ``snapshot`` record that replaces the
        dropped prefix (rename-before-truncate: the replacement is durable
        *before* the prefix is destroyed; see ``docs/durability.md``).  The
        surgery is segment bookkeeping only: dropped records are marked dead
        and segments that end up fully dead (except the append tail) are
        reclaimed.  No device I/O is charged — crash sites
        (``total_appended``) and ``bytes_appended`` are unaffected.
        """
        if not 0 <= upto <= len(self.records):
            raise ValueError(
                f"truncate({upto}) out of range: {len(self.records)} records retained"
            )
        if upto == 0:
            return 0
        for ptr in self._ptrs[:upto]:
            self._log.mark_dead(ptr)
        del self.records[:upto]
        del self._ptrs[:upto]
        for seg in self._log.iter_segments():
            if seg.live_bytes == 0 and seg is not self._log._tail:
                self._log.reclaim(seg.segment_id)
        return upto

    def replay(self) -> list[dict]:
        """The durable record stream, oldest first (for recovery replay)."""
        return list(self.records)

    # -------------------------------------------------------- fault injection
    def crash_after(self, n_records: int) -> None:
        """Arm an injected crash: the append of record ``n_records`` raises.

        ``n_records`` counts *all appends since genesis* (``total_appended``,
        which truncation never rewinds), so a harness that wants to crash at
        the ``k``-th site of a scenario arms
        ``crash_after(log.total_appended + k)`` before driving it.  Appends below
        the armed site proceed normally; the log stays readable (recovery
        replays the durable prefix).  Disarm with :meth:`disarm`.
        """
        if n_records < 0:
            raise ValueError(f"crash site must be >= 0, got {n_records}")
        self._crash_after = n_records

    def disarm(self) -> None:
        self._crash_after = None


__all__ = ["CrashPoint", "MetadataLog"]
