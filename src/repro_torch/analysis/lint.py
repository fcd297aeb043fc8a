"""Static contract linter: pluggable ``ast`` rules over ``# contract:`` markers.

Each rule is a class with a ``name`` and a ``check(mod) -> list[Violation]``;
the :data:`RULES` registry is the pluggable surface — adding a rule is
appending a class here (and seeding ``tests/fixtures/lint_bad/`` with a
planted violation so the self-test proves it fires; ``--self-test`` fails if
any registered rule has no bad-fixture coverage).

The rules encode the contracts PRs 1-5 established (see ``docs/analysis.md``):

* ``no-nondeterminism`` — modeled paths must be bit-identical across
  processes: no builtin ``hash()``, no wall-clock reads (``time.time`` and
  friends; ``time.sleep`` is pacing, not modeling, and is allowed), no stdlib
  ``random`` (seeded ``numpy`` generators are fine).
* ``coordinator-only-locks`` — ``threading`` lock objects may only be created
  inside functions annotated ``coordinator-only``: worker threads racing to
  create a lock would hand two tasks *different* locks and blind the very
  exclusivity assertion the lock implements.
* ``stats-lock`` — shared front-end counters (``self.gets += 1`` etc.) may be
  mutated only under ``with ..._stats_lock:`` or inside ``coordinator-only``
  functions.  Per-store ``self.stats.*`` counters are out of scope: each
  backing store is single-threaded by the executor's exclusivity contract.
* ``record-then-apply`` — in annotated functions, topology state may only be
  mutated *after* the first durable ``metalog.append`` record call (the WAL
  replay discipline: a crash before the record means the action never was).
* ``flush-before-record`` — in annotated functions, the first ``flush``/
  ``flush_all`` must precede the first durable-record write (the redo record
  must not cover data that is not yet durable — the PR 1 dangling-pointer
  class of bug).
* ``rename-before-truncate`` — in annotated functions, the first
  ``.truncate(...)`` call must follow the first replacement write
  (``metalog.append``, ``os.replace``/``os.rename``, or
  ``atomic_write_bytes``): history may only be dropped *after* the state it
  summarized has been durably republished — a crash between the truncate and
  the replacement would lose the only copy (the PR 7 snapshot discipline).
* ``lock-free-hot-path`` — functions annotated ``single-threaded`` are
  modeled hot paths and must not acquire or create locks.
* ``contract-annotation`` — annotation hygiene: unknown markers and
  ``exempt`` without a justification are themselves violations.

Run as ``scripts/lint_contracts.py`` (the CI hard gate).
"""
from __future__ import annotations

import ast
import dataclasses

from .contracts import ModuleContracts

# shared front-end counters (BaseShardedStore / RangeShardedStore); the
# stats-lock rule matches direct attributes only (``self.gets``), never
# ``self.stats.gets`` — per-store StoreStats are executor-serialized
FRONTEND_COUNTERS = frozenset([
    "gets", "get_probes", "get_fallbacks", "scans", "scan_probes",
    "splits", "merges", "migrated_keys", "migration_ticks",
])

# topology state covered by the record-then-apply discipline: the range
# boundary map and shard registries, plus the elastic-rescale state shared by
# both partitioning schemes (concurrent migration legs, the rescale
# coordinator, and a shrinking hash fleet's draining ex-slots)
TOPOLOGY_ATTRS = frozenset([
    "boundaries", "shards", "_shard_ids", "_migration",
    "_migrations", "_rescale", "_draining",
])
_MUTATOR_METHODS = frozenset([
    "insert", "append", "pop", "remove", "clear", "extend", "sort", "reverse",
])

_LOCK_FACTORIES = frozenset([
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore", "Barrier", "Event",
])

_WALLCLOCK_FNS = frozenset([
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter", "perf_counter_ns",
])


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    lineno: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.lineno}: [{self.rule}] {self.message}"


def _attr_chain_root(node: ast.AST) -> ast.AST:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node


def _is_threading_lock_call(node: ast.Call) -> bool:
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr in _LOCK_FACTORIES
            and isinstance(f.value, ast.Name) and f.value.id == "threading")


class Rule:
    """Base: subclass, set ``name``, implement :meth:`check`."""

    name = "rule"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        raise NotImplementedError

    def _v(self, mod: ModuleContracts, lineno: int, message: str) -> Violation:
        return Violation(mod.path, lineno, self.name, message)


class NoNondeterminismRule(Rule):
    name = "no-nondeterminism"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name) and f.id == "hash":
                    out.append(self._v(mod, node.lineno,
                                       "builtin hash() is PYTHONHASHSEED-randomized; "
                                       "use zlib.crc32 in modeled paths"))
                elif (isinstance(f, ast.Attribute) and f.attr in _WALLCLOCK_FNS
                      and isinstance(f.value, ast.Name) and f.value.id == "time"):
                    out.append(self._v(mod, node.lineno,
                                       f"wall-clock time.{f.attr}() in a modeled path; "
                                       "model time via Device.device_time"))
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random" or alias.name.startswith("random."):
                        out.append(self._v(mod, node.lineno,
                                           "stdlib random is process-seeded; use a seeded "
                                           "numpy Generator (np.random.default_rng)"))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    out.append(self._v(mod, node.lineno,
                                       "stdlib random is process-seeded; use a seeded "
                                       "numpy Generator (np.random.default_rng)"))
        return out


class CoordinatorOnlyLocksRule(Rule):
    name = "coordinator-only-locks"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _is_threading_lock_call(node):
                if not mod.has_marker(node, "coordinator-only"):
                    out.append(self._v(
                        mod, node.lineno,
                        f"threading.{node.func.attr}() created outside a "
                        "'# contract: coordinator-only' function (racing lock "
                        "creation hands tasks different locks)"))
        return out


class StatsLockRule(Rule):
    name = "stats-lock"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        self._scan(mod, mod.tree, False, out)
        return out

    @staticmethod
    def _is_stats_lock_with(node: ast.With) -> bool:
        return any(isinstance(item.context_expr, ast.Attribute)
                   and item.context_expr.attr == "_stats_lock"
                   for item in node.items)

    def _scan(self, mod, node, locked, out) -> None:
        for child in ast.iter_child_nodes(node):
            child_locked = locked
            if isinstance(child, ast.With) and self._is_stats_lock_with(child):
                child_locked = True
            targets = []
            if isinstance(child, ast.AugAssign):
                targets = [child.target]
            elif isinstance(child, ast.Assign):
                targets = child.targets
            for t in targets:
                if (isinstance(t, ast.Attribute) and t.attr in FRONTEND_COUNTERS
                        and isinstance(t.value, ast.Name)):
                    if not child_locked and not mod.has_marker(child, "coordinator-only"):
                        out.append(self._v(
                            mod, child.lineno,
                            f"front-end counter '{t.value.id}.{t.attr}' mutated outside "
                            "'with ..._stats_lock:' and outside a coordinator-only "
                            "function"))
            self._scan(mod, child, child_locked, out)


def _record_call_lineno(fn: ast.AST, *, include_device_writes: bool) -> int | None:
    """Line of the first durable-record call in ``fn``: ``*.metalog.append(...)``
    and, for the flush rule, ``*.device.sequential_write(...)`` (the store's
    redo-record idiom)."""
    best: int | None = None
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        hit = (f.attr == "append" and isinstance(f.value, ast.Attribute)
               and f.value.attr == "metalog")
        if include_device_writes and not hit:
            hit = (f.attr == "sequential_write" and isinstance(f.value, ast.Attribute)
                   and f.value.attr == "device")
        if hit and (best is None or node.lineno < best):
            best = node.lineno
    return best


class RecordThenApplyRule(Rule):
    name = "record-then-apply"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        for fn in mod.functions_with("record-then-apply"):
            record_line = _record_call_lineno(fn, include_device_writes=False)
            if record_line is None:
                out.append(self._v(
                    mod, fn.lineno,
                    f"'{fn.name}' is annotated record-then-apply but never calls "
                    "metalog.append"))
                continue
            for node, attr in self._topology_mutations(fn):
                if node.lineno < record_line:
                    out.append(self._v(
                        mod, node.lineno,
                        f"topology state '{attr}' mutated before the metalog.append "
                        f"record at line {record_line} (a crash here would leave "
                        "applied-but-unrecorded state)"))
        return out

    @staticmethod
    def _topo_attr(node: ast.AST) -> str | None:
        """The topology attribute a store/delete target touches, if any."""
        if isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute) and node.attr in TOPOLOGY_ATTRS
                and isinstance(node.value, ast.Name)):
            return node.attr
        return None

    def _topology_mutations(self, fn: ast.AST):
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    attr = self._topo_attr(t)
                    if attr is not None:
                        yield node, attr
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    attr = self._topo_attr(t)
                    if attr is not None:
                        yield node, attr
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr in _MUTATOR_METHODS:
                    attr = self._topo_attr(node.func.value)
                    if attr is not None:
                        yield node, attr


class FlushBeforeRecordRule(Rule):
    name = "flush-before-record"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        for fn in mod.functions_with("flush-before-record"):
            flush_line = None
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("flush", "flush_all")):
                    if flush_line is None or node.lineno < flush_line:
                        flush_line = node.lineno
            record_line = _record_call_lineno(fn, include_device_writes=True)
            if record_line is None:
                out.append(self._v(
                    mod, fn.lineno,
                    f"'{fn.name}' is annotated flush-before-record but writes no "
                    "durable record (metalog.append / device.sequential_write)"))
            elif flush_line is None:
                out.append(self._v(
                    mod, fn.lineno,
                    f"'{fn.name}' is annotated flush-before-record but never "
                    "flushes before its record"))
            elif record_line < flush_line:
                out.append(self._v(
                    mod, record_line,
                    f"durable record written before the flush at line {flush_line}: "
                    "the record must not cover data that is not yet durable"))
        return out


class RenameBeforeTruncateRule(Rule):
    name = "rename-before-truncate"

    @staticmethod
    def _replacement_lineno(fn: ast.AST) -> int | None:
        """Line of the first replacement write: ``*.metalog.append(...)``,
        ``os.replace``/``os.rename``, or ``atomic_write_bytes(...)``."""
        best = _record_call_lineno(fn, include_device_writes=False)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hit = (isinstance(f, ast.Name) and f.id == "atomic_write_bytes")
            if not hit:
                hit = (isinstance(f, ast.Attribute) and f.attr in ("replace", "rename")
                       and isinstance(f.value, ast.Name) and f.value.id == "os")
            if hit and (best is None or node.lineno < best):
                best = node.lineno
        return best

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        for fn in mod.functions_with("rename-before-truncate"):
            truncate_line = None
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "truncate"):
                    if truncate_line is None or node.lineno < truncate_line:
                        truncate_line = node.lineno
            replacement_line = self._replacement_lineno(fn)
            if truncate_line is None:
                out.append(self._v(
                    mod, fn.lineno,
                    f"'{fn.name}' is annotated rename-before-truncate but never "
                    "calls .truncate(...)"))
            elif replacement_line is None:
                out.append(self._v(
                    mod, truncate_line,
                    f"'{fn.name}' truncates history but writes no replacement "
                    "(metalog.append / os.replace / atomic_write_bytes): a crash "
                    "after the truncate loses the only copy"))
            elif truncate_line < replacement_line:
                out.append(self._v(
                    mod, truncate_line,
                    f"history truncated before the replacement write at line "
                    f"{replacement_line}: a crash between them loses the only copy"))
        return out


class LockFreeHotPathRule(Rule):
    name = "lock-free-hot-path"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        out = []
        for fn in mod.functions_with("single-threaded"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "acquire"):
                        out.append(self._v(
                            mod, node.lineno,
                            f"lock acquire in single-threaded hot path '{fn.name}'"))
                    elif _is_threading_lock_call(node):
                        out.append(self._v(
                            mod, node.lineno,
                            f"lock created in single-threaded hot path '{fn.name}'"))
                elif isinstance(node, ast.With):
                    for item in node.items:
                        e = item.context_expr
                        if isinstance(e, ast.Attribute) and "lock" in e.attr.lower():
                            out.append(self._v(
                                mod, node.lineno,
                                f"'with {e.attr}:' in single-threaded hot path "
                                f"'{fn.name}'"))
        return out


class AnnotationHygieneRule(Rule):
    name = "contract-annotation"

    def check(self, mod: ModuleContracts) -> list[Violation]:
        return [self._v(mod, p.lineno, p.message) for p in mod.problems]


RULES: list[Rule] = [
    NoNondeterminismRule(),
    CoordinatorOnlyLocksRule(),
    StatsLockRule(),
    RecordThenApplyRule(),
    FlushBeforeRecordRule(),
    RenameBeforeTruncateRule(),
    LockFreeHotPathRule(),
    AnnotationHygieneRule(),
]


def lint_source(path: str, source: str) -> list[Violation]:
    """All rules over one source text; ``exempt``-covered lines are dropped
    (the hygiene rule is never exemptable — a bad annotation cannot justify
    itself)."""
    mod = ModuleContracts(path, source)
    out: list[Violation] = []
    for rule in RULES:
        for v in rule.check(mod):
            if rule.name != AnnotationHygieneRule.name and mod.exempted(v.lineno):
                continue
            out.append(v)
    return sorted(out, key=lambda v: (v.path, v.lineno, v.rule))


def lint_paths(paths) -> list[Violation]:
    out: list[Violation] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            out.extend(lint_source(str(path), fh.read()))
    return out


__all__ = [
    "FRONTEND_COUNTERS",
    "RULES",
    "Rule",
    "TOPOLOGY_ATTRS",
    "Violation",
    "lint_paths",
    "lint_source",
]
