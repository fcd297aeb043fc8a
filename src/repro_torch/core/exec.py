"""Async pipelined shard execution engine (PR 4).

The front-ends' batched ops execute shard-by-shard, so the modeled
``device_time = max over shards`` overlap was *pretended*, never realized —
while the paper's headline wins (up to 12.4x vs RocksDB) come from keeping the
NVMe device busy with overlapped, mostly-sequential I/O.
:class:`ShardExecutor` makes the overlap real:

* **Per-shard FIFO work queues.**  A batch is routed/partitioned on the
  submitting (coordinator) thread and each shard's sub-batch becomes one task
  on that shard's queue; a shared ``ThreadPoolExecutor`` drains the queues,
  one in-flight task per queue.  Shards are independent stores, so tasks on
  different queues commute — and each task *asserts* the independence
  invariant with a non-blocking per-store lock acquire (a blocked acquire
  means two tasks touched one store: the executor raises instead of silently
  corrupting stats; see the thread-safety audit in ``store.py``).

* **Pipelining.**  Submission returns immediately (bounded by a backpressure
  window), so batch N+1's routing/partitioning on the coordinator overlaps
  batch N's shard work on the pool — the front of the pipeline never waits
  for the device.

* **Sequence points.**  Anything that reads or mutates cross-shard state —
  ``migration_tick``, the skew rebalancer, range-store scans, crash/recover —
  runs via :meth:`exclusive`: drain all queues, run the function on the
  coordinator, resume.  Because only the coordinator submits work, this is a
  full barrier with no reader/writer lock machinery, and it makes async
  execution *byte-identical to serial*: the per-shard projection of the op
  stream is exactly the serial path's, and every policy decision happens at
  the same op-stream position with the same counter values
  (``tests/test_exec.py`` is the differential oracle).

* **Background maintenance.**  Large-log GC on a hash front-end is enqueued
  per shard (:meth:`gc_tick`) — truly off the foreground path, ordered only
  against its own shard's traffic.  Migration ticks stay sequence points
  (they touch two shards and append WAL records whose order must match apply
  order — see ``metalog.py``), but the *driver* never blocks submitting them:
  ``ycsb.execute_async`` interleaves them between batches exactly where the
  serial driver does, bounded by the same ``migrate_budget``.

* **Double-routing safety.**  While a migration is in flight, reads routed to
  the destination may fall back to the draining source — two stores, one
  logical shard.  The coordinator maps both stores' queues onto one merged
  queue key for the duration, so pair-touching tasks serialize with both
  sides' foreground work.

**Pacing (measured vs modeled time).**  This container runs CPython with a
GIL: pure-Python shard work cannot overlap in wall-clock no matter how many
workers run.  What *does* overlap — and what the paper's engine overlaps — is
device time.  With ``pace > 0`` every task sleeps ``pace x`` the modeled
device-time delta of the stores it touched (sleeps release the GIL), so
measured wall-clock becomes a faithful execution of the byte-accounted device
model: 1 worker realizes the ``serial`` overlap policy, k workers approximate
``channels:k``, and many workers approach ``ideal``
(:func:`repro.core.io.overlap_time`).  Benchmarks compare the modeled
policies against measured paced wall-clock per run; the default ``pace=0``
adds no sleeps and is what tests use.

The executor is **single-coordinator**: exactly one thread may submit
batches/maintenance.  Results and stats are byte-identical to serial
execution regardless of ``workers``/``pipeline``/pacing.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

from .shard import BaseShardedStore
from .store import ParallaxStore


class _ShardQueue:
    """FIFO of tasks for one shard (or one migration pair), at most one
    in-flight drainer on the pool at a time."""

    __slots__ = ("items", "active")

    def __init__(self):
        self.items: deque = deque()
        self.active = False


class BatchHandle:
    """Completion handle for one submitted batch (its per-shard tasks).

    ``result()`` blocks until every task of the batch ran and returns the
    batch's value (the filled output list for ``get_many``, ``None`` for
    writes), re-raising the first executor error if any task failed.
    """

    __slots__ = ("_ex", "_remaining", "value")

    def __init__(self, ex: "ShardExecutor", ntasks: int, value=None):
        self._ex = ex
        self._remaining = ntasks
        self.value = value

    def result(self, timeout: float | None = None):
        with self._ex._cv:
            ok = self._ex._cv.wait_for(lambda: self._remaining == 0 or self._ex._errors,
                                       timeout=timeout)
            if not ok:
                raise TimeoutError("batch did not complete in time")
            self._ex._raise_if_failed_locked()
        return self.value


class ShardExecutor:
    """Drains a sharded store's batched ops through per-shard queues.

    Parameters:

    * ``workers`` — pool threads; with pacing, realizes up to that many
      overlapped device channels.
    * ``pipeline`` — submission returns before the batch completes (up to
      ``max_pending`` batches in flight); off = every batch is drained before
      the next is accepted (still fans out *within* the batch).
    * ``pace`` — seconds of sleep per modeled device-second a task incurred
      (0 = no pacing; see module docstring).
    """

    # contract: coordinator-only
    def __init__(self, store: BaseShardedStore, workers: int = 4, *,
                 pipeline: bool = True, pace: float = 0.0, max_pending: int = 8):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.store = store
        self.workers = workers
        self.pipeline = pipeline
        self.pace = pace
        self.max_pending = max(1, max_pending)
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="shard-exec")
        self._cv = threading.Condition()
        self._queues: dict = {}
        self._pending = 0          # tasks enqueued but not finished
        self._errors: list[BaseException] = []
        self._inflight: deque[BatchHandle] = deque()
        self._locks: dict[int, threading.Lock] = {}  # id(store) -> exclusivity lock
        self._closed = False
        # a front-end with a nontrivial _after_batch (the range store's
        # migration/rebalance policy) needs a sequence point per batch to stay
        # byte-identical to serial; a hash front-end pipelines barrier-free
        self._has_policy = type(store)._after_batch is not BaseShardedStore._after_batch

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "ShardExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(wait=exc_type is None)

    def close(self, wait: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if wait:
                self.drain()
        finally:
            self._pool.shutdown(wait=True)

    # -------------------------------------------------------------- plumbing
    def _raise_if_failed_locked(self) -> None:
        if self._errors:
            raise RuntimeError("shard executor task failed") from self._errors[0]

    def _leg_groups(self) -> dict:
        """Merged queue keys for every shard id touched by an in-flight
        migration leg: union-find over the legs' src/dst pairs.  Shard ids
        connected (transitively) by legs share one ``("mig", root)`` key —
        their queues serialize — while *disjoint* groups keep distinct keys,
        so a rescale's independent legs drain concurrently.  With a single
        legacy leg this degenerates to the old ``("mig", min(src, dst))``."""
        legs = getattr(self.store, "migrations", ())
        if not legs:
            return {}
        parent: dict[int, int] = {}

        def find(x: int) -> int:
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:
                parent[x], x = root, parent[x]
            return root

        for m in legs:
            parent.setdefault(m.src_id, m.src_id)
            parent.setdefault(m.dst_id, m.dst_id)
            a, b = find(m.src_id), find(m.dst_id)
            if a != b:
                parent[max(a, b)] = min(a, b)
        return {sid: ("mig", find(sid)) for sid in parent}

    def _queue_key(self, sid: int):
        """Stable queue identity for shard index ``sid``: the shard id where
        the store has stable ids (range), the index otherwise (hash).  Every
        shard in a migration leg group collapses to the group's merged key —
        double-routed reads touch both sides of a leg, so each group must
        serialize (but only within itself; see :meth:`_leg_groups`)."""
        ids = getattr(self.store, "_shard_ids", None)
        key = ids[sid] if ids is not None else sid
        return self._leg_groups().get(key, key)

    def _group_stores(self, qkey) -> list[ParallaxStore]:
        """Backing stores of one merged migration group — the set a
        double-routed read submitted under ``qkey`` may touch.  Only this
        group's stores are locked by its tasks: locking another group's
        stores would contend with that group's own (concurrent) tasks and
        trip the shard-independence assertion spuriously."""
        groups = self._leg_groups()
        return [self.store._store_of_id(sid)
                for sid, key in groups.items() if key == qkey]

    # contract: coordinator-only
    def _new_store_lock(self) -> threading.Lock:
        """Factory for per-store exclusivity locks — the *only* place they are
        created (worker threads must never create locks: two racing creations
        would hand mis-queued tasks *different* locks and blind the very
        assertion they implement).  The race detector overrides this per
        instance to hand out tracked locks."""
        return threading.Lock()

    def _lock_of(self, store: ParallaxStore) -> threading.Lock:
        """Coordinator-only: the per-store exclusivity lock, created at
        enqueue time."""
        with self._cv:
            lock = self._locks.get(id(store))
            if lock is None:
                lock = self._locks[id(store)] = self._new_store_lock()
            return lock

    def _enqueue(self, key, stores: list[ParallaxStore], fn: Callable[[], None],
                 handle: BatchHandle) -> None:
        # NOTE: earlier task failures are NOT raised here — submission racing
        # a worker's failure would make the raise site nondeterministic.
        # Errors surface only at sync points (drain / BatchHandle.result /
        # exclusive), which every driver reaches promptly (backpressure,
        # per-batch policy hooks, end-of-stream drain).
        with self._cv:
            if self._closed:
                raise RuntimeError("executor is closed")
            # pre-create the stores' exclusivity locks here, on the single
            # submitter, so workers only ever *read* self._locks
            for s in stores:
                if id(s) not in self._locks:
                    self._locks[id(s)] = self._new_store_lock()
            self._pending += 1
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _ShardQueue()
            q.items.append((stores, fn, handle))
            if not q.active:
                q.active = True
                self._pool.submit(self._drain_queue, q)

    def _drain_queue(self, q: _ShardQueue) -> None:
        while True:
            with self._cv:
                if not q.items:
                    q.active = False
                    return
                stores, fn, handle = q.items.popleft()
            try:
                self._run_task(stores, fn)
            except BaseException as e:  # noqa: BLE001 — reported via drain/result
                with self._cv:
                    self._errors.append(e)
            finally:
                with self._cv:
                    self._pending -= 1
                    if handle is not None:
                        handle._remaining -= 1
                    self._cv.notify_all()

    def _run_task(self, stores: list[ParallaxStore], fn: Callable[[], None]) -> None:
        # shard-independence assertion: queue FIFO already guarantees one task
        # per store, so a blocked acquire is an invariant violation, not a
        # wait-for condition (locks pre-created at enqueue; read-only here)
        locks = [self._locks[id(s)] for s in stores]
        acquired = []
        try:
            for lock in locks:
                if not lock.acquire(blocking=False):
                    raise RuntimeError(
                        "shard-independence violated: two executor tasks "
                        "touched one store concurrently"
                    )
                acquired.append(lock)
            before = sum(s.device.device_time() for s in stores) if self.pace else 0.0
            fn()
        finally:
            for lock in acquired:
                lock.release()
        if self.pace:
            busy = sum(s.device.device_time() for s in stores) - before
            if busy > 0:
                time.sleep(busy * self.pace)

    def _track(self, handle: BatchHandle) -> BatchHandle:
        """Backpressure: cap the pipelined window, or drain when pipelining
        is off (within-batch fan-out only)."""
        if not self.pipeline:
            handle.result()
            return handle
        self._inflight.append(handle)
        while len(self._inflight) > self.max_pending:
            self._inflight.popleft().result()
        return handle

    # ---------------------------------------------------------- sequencing
    def drain(self) -> None:
        """Block until every submitted task has finished; re-raise failures."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0)
            self._raise_if_failed_locked()
        self._inflight.clear()

    def exclusive(self, fn: Callable[[], object]):
        """Run ``fn`` at a sequence point: all queues drained, nothing else in
        flight (the coordinator is the only submitter).  Cross-shard reads
        (scans), policy ticks, GC on adaptive stores, crash/recover and
        topology mutations all come through here; with pacing, the stall is
        charged like any task (a synchronous maintenance stall)."""
        self.drain()
        before = self._fleet_time() if self.pace else 0.0
        try:
            return fn()
        finally:
            if self.pace:
                busy = self._fleet_time() - before
                if busy > 0:
                    time.sleep(busy * self.pace)

    def _fleet_time(self) -> float:
        total = sum(s.device.device_time() for s in self.store._all_stores())
        meta = getattr(self.store, "meta_device", None)
        return total + (meta.device_time() if meta is not None else 0.0)

    # ------------------------------------------------------------ batched ops
    def _submit_write(self, op: str, items: Sequence, keys: Sequence[bytes]) -> BatchHandle:
        groups = self.store._group(keys)
        handle = BatchHandle(self, len(groups))
        for sid, positions in groups.items():
            shard = self.store.shards[sid]
            sub = [items[p] for p in positions]
            # writes touch only the routed shard (pending-region writes go to
            # the migration destination, whose queue key is the merged pair —
            # so they still serialize against double-routed reads)
            self._enqueue(self._queue_key(sid), [shard], self._write_fn(op, shard, sub), handle)
        return self._track(handle)

    @staticmethod
    def _write_fn(op: str, shard: ParallaxStore, sub: list) -> Callable[[], None]:
        if op == "put":
            def fn():
                for key, value in sub:
                    shard.put(key, value)
        elif op == "update":
            def fn():
                for key, value in sub:
                    shard.update(key, value)
        else:
            def fn():
                for key in sub:
                    shard.delete(key)
        return fn

    def put_many(self, items: Sequence[tuple[bytes, bytes]]) -> BatchHandle:
        return self._submit_write("put", items, [k for k, _ in items])

    def update_many(self, items: Sequence[tuple[bytes, bytes]]) -> BatchHandle:
        return self._submit_write("update", items, [k for k, _ in items])

    def delete_many(self, keys: Sequence[bytes]) -> BatchHandle:
        return self._submit_write("delete", keys, keys)

    def get_many(self, keys: Sequence[bytes]) -> BatchHandle:
        """Batched point reads; ``.result()`` yields the value list in key
        order (same totals and per-shard traffic as the serial path)."""
        store = self.store
        groups = store._group(keys)
        out: list[bytes | None] = [None] * len(keys)
        handle = BatchHandle(self, len(groups), value=out)
        # batch-level counter bumps on the coordinator (the serial path bumps
        # per key; the totals are identical) — locked against the worker-side
        # fallback-probe bumps of the double-routing read path
        with store._stats_lock:
            store.gets += len(keys)
            store.get_probes += len(keys)
        for sid, positions in groups.items():
            shard = store.shards[sid]
            qkey = self._queue_key(sid)
            # only tasks on a merged migration queue can double-route into
            # that group's stores (pending-region keys route to a leg's
            # destination, whose queue key is the group's); they lock the
            # group's stores and nothing else — see _group_stores
            if isinstance(qkey, tuple):
                group = self._group_stores(qkey)
                stores = [shard] + [s for s in group if s is not shard]
            else:
                stores = [shard]

            def fn(sid=sid, positions=positions):
                for pos in positions:
                    out[pos] = store._get_from(sid, keys[pos])

            self._enqueue(qkey, stores, fn, handle)
        return self._track(handle)

    def scan(self, start: bytes, count: int) -> list[tuple[bytes, bytes]]:
        """Sorted scan at a sequence point (it reads across shards, and on
        adaptive stores it feeds the skew window / ticks the policy exactly
        like the serial path)."""
        return self.exclusive(lambda: self.store.scan(start, count))

    # ------------------------------------------------------------ maintenance
    def after_batch(self) -> None:
        """The serial path's per-batch policy hook, as a sequence point.

        Hash front-ends have a no-op hook: nothing is scheduled and the
        pipeline keeps flowing.  Policy stores (range) evaluate the rebalancer
        / advance the in-flight migration exactly once per batch, exactly
        like ``BaseShardedStore``'s batched ops do inline."""
        if self._has_policy:
            self.exclusive(self.store._after_batch)

    def migration_tick(self, budget: int | None = None) -> int:
        """Advance an in-flight migration at a sequence point (bounded by
        ``budget`` keys, defaulting to the store's ``migration_batch_keys``)."""
        tick = getattr(self.store, "migration_tick", None)
        if tick is None:
            return 0
        return self.exclusive(lambda: tick(budget))

    def gc_tick(self, force: bool = False) -> None:
        """Large-log GC off the foreground path.

        On a policy-free (hash) front-end each shard's GC is enqueued on that
        shard's queue: it runs behind the shard's earlier foreground work and
        ahead of later work — the same per-shard projection as the serial
        path's stop-the-world ``gc_tick`` — while other shards' foreground
        traffic keeps flowing.  Policy stores run it at a sequence point (its
        ``_after_batch`` must see the post-GC counters, like serial), and so
        does a hash store mid-rescale: ``_all_stores()`` then includes
        draining ex-slots whose list position is not their queue identity,
        so per-shard enqueueing would mis-key their tasks."""
        if self._has_policy or getattr(self.store, "migrations", ()):
            self.exclusive(lambda: self.store.gc_tick(force=force))
            return
        handle = BatchHandle(self, len(self.store._all_stores()))
        for i, shard in enumerate(self.store._all_stores()):
            def fn(shard=shard):
                shard.gc_tick(force=force)
            self._enqueue(self._queue_key(i), [shard], fn, handle)
        self._track(handle)


__all__ = ["BatchHandle", "ShardExecutor"]
