"""Static conformance pass: the code against :data:`~.spec.WAL_SPEC`.

An ``ast``-based intraprocedural CFG + dataflow analysis over the protocol's
implementation files (``repro_torch/core/{metalog,range_shard,shard,store}.py`` and
``repro_torch/elastic/remap.py``): every ``MetadataLog.append`` call site is
resolved to its record kind(s) — through flow-sensitive reaching definitions
when the record is built in a local variable and extended with conditional
``rec["key"] = ...`` assigns — and checked against the spec on every path:

* **undeclared-kind / unappended-kind** — the appended kind must exist in the
  spec, and (with ``require_complete``) every spec kind must be appended
  somewhere in the analyzed tree: adding a record kind to the code without
  extending the spec, or to the spec without wiring it up, is a hard failure.
* **unresolved-kind** — an append whose argument cannot be resolved to dict
  literals with a constant ``"kind"`` defeats the whole analysis and is
  itself a violation (the protocol implementation must stay analyzable).
* **payload-keys** — on every resolved path, required keys present and no
  keys outside the spec's ``required | optional``.
* **order** — the automaton run over *feasible-state sets*: a function's
  entry state is unknown, so the set starts as all states and each append
  keeps only the states reachable through that kind's transitions; an empty
  set means no caller state could make the emission sequence legal.
* **fence-flush** — kinds fenced ``flush-before-append`` need a
  ``<store>.flush_all()`` that reaches the append on every path with the
  flushed receiver not written in between (must-dataflow over receiver
  variables; a loop that only flushes counts as flushing the fleet).
* **fence-apply** — kinds fenced ``record-then-apply`` must not be preceded
  (on any path) by a mutation of the topology attributes the record
  describes (``TOPOLOGY_ATTRS``, shared with :mod:`repro_torch.analysis.lint`).
* **fence-truncate** — ``metalog.truncate`` only after an append of a
  ``truncate-after-append`` kind on every path (rename-before-truncate).

The analysis is deliberately conservative where it must approximate:
``return``/``raise``/``break``/``continue`` kill their paths, branch joins
union reaching record shapes and automaton states, and loops are iterated to
a small fixpoint.  Run it as ``scripts/check_protocol_torch.py`` (a CI hard gate
next to ``lint_contracts``), or call :func:`check_paths` directly.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

from ..lint import TOPOLOGY_ATTRS, Violation
from .spec import (
    FLUSH_BEFORE_APPEND,
    RECORD_THEN_APPLY,
    TRUNCATE_AFTER_APPEND,
    ProtocolSpec,
    WAL_SPEC,
)

#: every rule this pass can emit (mirrors ``lint.RULES`` for self-test coverage)
PROTOCOL_RULES = (
    "undeclared-kind", "unappended-kind", "unresolved-kind", "payload-keys",
    "order", "fence-flush", "fence-apply", "fence-truncate",
)

# store methods that make a receiver's logs dirty (volatile) again
_DIRTYING_METHODS = frozenset([
    "_write", "put", "put_many", "update", "delete", "delete_range",
    "delete_many", "load_rows", "write",
])
_FLUSH_METHODS = frozenset(["flush_all"])
# container mutators that count as a topology mutation on a TOPOLOGY_ATTRS
_TOPO_MUTATORS = frozenset([
    "insert", "append", "pop", "remove", "clear", "extend", "sort", "reverse",
    "update",
])

_CLEAN, _DIRTY = "clean", "dirty"


@dataclasses.dataclass(frozen=True)
class AppendSite:
    """One statically resolved ``metalog.append`` call site."""

    path: str
    lineno: int
    func: str
    kind: str  # "" when unresolved


@dataclasses.dataclass(frozen=True)
class _DictFact:
    """Abstract value of a record dict: its kind and key set."""

    kind: str | None  # None: no constant "kind" key
    keys: frozenset
    open: bool  # non-constant keys / ** expansion: unknown-key check off


class _State:
    """Abstract state at one program point (one path bundle)."""

    __slots__ = ("feasible", "flush", "defs", "topo_mutated", "truncate_ok",
                 "live")

    def __init__(self, feasible):
        self.feasible = feasible      # frozenset of automaton states
        self.flush = {}               # var -> _CLEAN | _DIRTY (absent: unknown)
        self.defs = {}                # var -> frozenset[_DictFact] | None
        self.topo_mutated = False     # may-analysis
        self.truncate_ok = False      # must-analysis
        self.live = True

    def copy(self) -> "_State":
        s = _State(self.feasible)
        s.flush = dict(self.flush)
        s.defs = dict(self.defs)
        s.topo_mutated = self.topo_mutated
        s.truncate_ok = self.truncate_ok
        s.live = self.live
        return s

    def key(self):
        return (self.feasible, tuple(sorted(self.flush.items())),
                tuple(sorted((k, v) for k, v in self.defs.items()
                             if v is not None)),
                self.topo_mutated, self.truncate_ok, self.live)


def _join(a: _State, b: _State) -> _State:
    if not a.live:
        return b
    if not b.live:
        return a
    out = _State(a.feasible | b.feasible)
    # flush status: must-join (clean only if clean on both paths)
    for var in set(a.flush) | set(b.flush):
        va, vb = a.flush.get(var), b.flush.get(var)
        if va == vb == _CLEAN:
            out.flush[var] = _CLEAN
        elif _DIRTY in (va, vb):
            out.flush[var] = _DIRTY
    # reaching record shapes: may-join (union of fact sets; None poisons)
    for var in set(a.defs) | set(b.defs):
        fa, fb = a.defs.get(var, None), b.defs.get(var, None)
        if fa is None or fb is None:
            out.defs[var] = None
        else:
            out.defs[var] = fa | fb
    out.topo_mutated = a.topo_mutated or b.topo_mutated
    out.truncate_ok = a.truncate_ok and b.truncate_ok
    return out


# ------------------------------------------------------------- ast utilities
def _is_metalog_recv(node: ast.AST) -> bool:
    """``self.metalog`` / ``st.metalog`` / bare ``metalog``."""
    return ((isinstance(node, ast.Attribute) and node.attr == "metalog")
            or (isinstance(node, ast.Name) and node.id == "metalog"))


def _recv_token(node: ast.AST) -> str | None:
    """A stable name for a call receiver: ``dst`` -> "dst", ``self.x`` ->
    "self.x"; subscripted/call receivers have no stable identity (None)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _recv_token(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _iter_calls(node: ast.AST):
    """Calls inside ``node`` in source (pre)order, skipping nested function
    and lambda bodies (they execute elsewhere, if at all)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(reversed(list(ast.iter_child_nodes(n))))


def _dict_fact(node: ast.Dict) -> _DictFact:
    keys, kind, open_ = set(), None, False
    for k, v in zip(node.keys, node.values):
        if k is None:  # ** expansion
            open_ = True
            continue
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
            if k.value == "kind":
                kind = v.value if (isinstance(v, ast.Constant)
                                   and isinstance(v.value, str)) else None
        else:
            open_ = True
    return _DictFact(kind, frozenset(keys), open_)


def _is_self_topo_target(node: ast.AST) -> bool:
    """``self.<topo>``, or a subscript/slice of it (``del self.shards[i]``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in TOPOLOGY_ATTRS)


# ---------------------------------------------------------------- the checker
class _FunctionChecker:
    def __init__(self, path: str, qualname: str, spec: ProtocolSpec):
        self.path = path
        self.qualname = qualname
        self.spec = spec
        self.violations: dict[tuple, Violation] = {}
        self.sites: dict[tuple, AppendSite] = {}

    # ------------------------------------------------------------- reporting
    def _report(self, lineno: int, rule: str, message: str) -> None:
        key = (lineno, rule)
        if key not in self.violations:
            self.violations[key] = Violation(self.path, lineno, rule, message)

    def _site(self, lineno: int, kind: str) -> None:
        self.sites.setdefault((lineno, kind),
                              AppendSite(self.path, lineno, self.qualname, kind))

    # ------------------------------------------------------------ call effects
    def _apply_call(self, call: ast.Call, state: _State) -> None:
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return
        recv = fn.value
        if fn.attr == "append" and _is_metalog_recv(recv):
            self._apply_append(call, state)
            return
        if fn.attr == "truncate" and _is_metalog_recv(recv):
            if not state.truncate_ok:
                self._report(
                    call.lineno, "fence-truncate",
                    "metalog.truncate without a durable snapshot-class append "
                    "on every path to it (rename-before-truncate: history may "
                    "only be destroyed after its replacement record commits)")
            return
        # topology mutation via container method: self.<topo>.insert(...)
        if (fn.attr in _TOPO_MUTATORS and isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name) and recv.value.id == "self"
                and recv.attr in TOPOLOGY_ATTRS):
            state.topo_mutated = True
            return
        token = _recv_token(recv)
        if fn.attr in _FLUSH_METHODS and token is not None:
            state.flush[token] = _CLEAN
        elif fn.attr in _DIRTYING_METHODS and token is not None:
            state.flush[token] = _DIRTY
            # a write anywhere invalidates whole-fleet flush facts
            for var in list(state.flush):
                if var.startswith("__fleet") or var == "self":
                    state.flush.pop(var)

    def _resolve_arg(self, call: ast.Call, state: _State):
        """The record argument's reaching dict facts, or None (unresolved)."""
        if len(call.args) != 1 or call.keywords:
            return None
        arg = call.args[0]
        if isinstance(arg, ast.Dict):
            return frozenset([_dict_fact(arg)])
        if isinstance(arg, ast.Name):
            facts = state.defs.get(arg.id, None)
            if facts:  # None (poisoned) and empty both mean unresolved
                return facts
        return None

    def _apply_append(self, call: ast.Call, state: _State) -> None:
        lineno = call.lineno
        facts = self._resolve_arg(call, state)
        if facts is None:
            self._report(
                lineno, "unresolved-kind",
                f"metalog.append argument in {self.qualname} cannot be "
                "resolved to dict literal(s) with a constant 'kind' — the "
                "protocol implementation must stay statically analyzable")
            self._site(lineno, "")
            return
        next_feasible = frozenset()
        stepped_kinds = []
        for fact in facts:
            if fact.kind is None:
                self._report(
                    lineno, "unresolved-kind",
                    f"record dict reaching metalog.append in {self.qualname} "
                    "has no constant 'kind' key")
                continue
            if fact.kind not in self.spec:
                self._report(
                    lineno, "undeclared-kind",
                    f"record kind {fact.kind!r} is appended here but not "
                    f"declared in the {self.spec.name} spec")
                continue
            kind = self.spec[fact.kind]
            self._site(lineno, kind.name)
            missing = kind.required - fact.keys
            unknown = (frozenset() if fact.open
                       else fact.keys - kind.payload_keys)
            if missing or unknown:
                parts = []
                if missing:
                    parts.append(f"missing required key(s) {sorted(missing)}")
                if unknown:
                    parts.append(f"key(s) {sorted(unknown)} not in the spec's "
                                 "required|optional set")
                self._report(lineno, "payload-keys",
                             f"{kind.name} payload: " + "; ".join(parts))
            stepped_kinds.append(kind)
            next_feasible |= kind.step(state.feasible)
            if FLUSH_BEFORE_APPEND in kind.fences:
                if _CLEAN not in state.flush.values():
                    self._report(
                        lineno, "fence-flush",
                        f"{kind.name} requires flush-before-append: no "
                        "store.flush_all() reaches this append on every path "
                        "(or the flushed store was written again in between) "
                        "— the data the record covers could be volatile when "
                        "it commits")
            if RECORD_THEN_APPLY in kind.fences and state.topo_mutated:
                self._report(
                    lineno, "fence-apply",
                    f"{kind.name} requires record-then-apply: topology state "
                    "(TOPOLOGY_ATTRS) is mutated before the append on some "
                    "path, so a crash at the record site would leave applied "
                    "but unjournaled state")
            if TRUNCATE_AFTER_APPEND in kind.fences:
                state.truncate_ok = True
        if stepped_kinds:
            if not next_feasible:
                names = sorted({k.name for k in stepped_kinds})
                self._report(
                    lineno, "order",
                    f"append of {'/'.join(names)} is infeasible here: no "
                    "automaton state consistent with the records already "
                    f"appended in {self.qualname} has a transition for it")
                # resynchronize so one bug does not cascade down the function
                next_feasible = frozenset(
                    to for k in stepped_kinds for _frm, to in k.transitions)
            state.feasible = next_feasible

    # --------------------------------------------------------- statement walk
    def _exec_expr_calls(self, node: ast.AST, state: _State) -> None:
        for call in _iter_calls(node):
            self._apply_call(call, state)

    def _exec_stmt(self, stmt: ast.stmt, state: _State) -> _State:
        if not state.live:
            return state
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Import, ast.ImportFrom,
                             ast.Global, ast.Nonlocal, ast.Pass)):
            return state
        if isinstance(stmt, ast.If):
            self._exec_expr_calls(stmt.test, state)
            then = self._exec_stmts(stmt.body, state.copy())
            other = self._exec_stmts(stmt.orelse, state.copy())
            return _join(then, other)
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            return self._exec_loop(stmt, state)
        if isinstance(stmt, ast.Try):
            body = self._exec_stmts(stmt.body, state.copy())
            merged = body
            for handler in stmt.handlers:
                # a handler can enter from any point in the body: start from
                # the pre-body state with may-facts from the body folded in
                h_in = state.copy()
                h_in.topo_mutated = state.topo_mutated or body.topo_mutated
                merged = _join(merged, self._exec_stmts(handler.body, h_in))
            if stmt.orelse:
                merged = _join(merged,
                               self._exec_stmts(stmt.orelse, body.copy()))
            if stmt.finalbody:
                merged = self._exec_stmts(stmt.finalbody, merged)
            return merged
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._exec_expr_calls(item.context_expr, state)
            return self._exec_stmts(stmt.body, state)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._exec_expr_calls(stmt, state)
            state.live = False
            return state
        if isinstance(stmt, (ast.Break, ast.Continue)):
            state.live = False
            return state
        # straight-line statements: evaluate calls, then apply bindings
        self._exec_expr_calls(stmt, state)
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                self._bind(target, stmt.value, state)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind(stmt.target, stmt.value, state)
        elif isinstance(stmt, ast.AugAssign):
            if _is_self_topo_target(stmt.target):
                state.topo_mutated = True
            elif isinstance(stmt.target, ast.Name):
                state.defs[stmt.target.id] = None
        elif isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                if _is_self_topo_target(target):
                    state.topo_mutated = True
        return state

    def _bind(self, target: ast.AST, value: ast.AST, state: _State) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, ast.Constant(value=None), state)
            return
        if _is_self_topo_target(target):
            state.topo_mutated = True
            return
        if isinstance(target, ast.Name):
            state.flush.pop(target.id, None)
            if isinstance(value, ast.Dict):
                state.defs[target.id] = frozenset([_dict_fact(value)])
            else:
                state.defs[target.id] = None
            return
        # rec["key"] = ...: extend every reaching dict fact of rec
        if (isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Name)):
            var = target.value.id
            facts = state.defs.get(var)
            if not facts:
                return
            key = target.slice
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                state.defs[var] = frozenset(
                    dataclasses.replace(f, keys=f.keys | {key.value})
                    for f in facts)
            else:
                state.defs[var] = frozenset(
                    dataclasses.replace(f, open=True) for f in facts)

    def _exec_loop(self, stmt, state: _State) -> _State:
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exec_expr_calls(stmt.iter, state)
            # the loop variable shadows any outer binding of the same name
            self._bind(stmt.target, ast.Constant(value=None), state)
            body_has_flush = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr in _FLUSH_METHODS
                for s in stmt.body for c in _iter_calls(s))
            body_writes = any(
                isinstance(c.func, ast.Attribute)
                and (c.func.attr in _DIRTYING_METHODS
                     or (c.func.attr == "append"
                         and _is_metalog_recv(c.func.value)))
                for s in stmt.body for c in _iter_calls(s))
        else:
            self._exec_expr_calls(stmt.test, state)
            body_has_flush = body_writes = False
        out = state.copy()
        for _ in range(3):  # small fixpoint: joins are monotone in practice
            prev = out.key()
            after = self._exec_stmts(stmt.body, out.copy())
            out = _join(out, after)
            if out.key() == prev:
                break
        if stmt.orelse:
            out = self._exec_stmts(stmt.orelse, out)
        # a loop that only flushes (``for s in stores: s.flush_all()``)
        # leaves the whole fleet clean even though its loop variable has no
        # stable identity across the must-join with the zero-iteration path
        if body_has_flush and not body_writes:
            out.flush[f"__fleet@{stmt.lineno}"] = _CLEAN
        return out

    def _exec_stmts(self, stmts, state: _State) -> _State:
        for s in stmts:
            state = self._exec_stmt(s, state)
        return state

    def run(self, fn) -> None:
        state = _State(self.spec.initial_states())
        self._exec_stmts(fn.body, state)


# ------------------------------------------------------------------ module API
def _functions(tree: ast.Module):
    """(qualname, node) for every function/method, outermost first."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield f"{prefix}{child.name}", child
                yield from walk(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
    yield from walk(tree, "")


def check_source(source: str, path: str = "<source>",
                 spec: ProtocolSpec = WAL_SPEC):
    """Check one module's source; returns ``(violations, sites)``."""
    tree = ast.parse(source, filename=path)
    violations: list[Violation] = []
    sites: list[AppendSite] = []
    for qualname, fn in _functions(tree):
        checker = _FunctionChecker(path, qualname, spec)
        checker.run(fn)
        violations.extend(checker.violations.values())
        sites.extend(checker.sites.values())
    violations.sort(key=lambda v: (v.lineno, v.rule))
    sites.sort(key=lambda s: s.lineno)
    return violations, sites


def default_targets() -> list[pathlib.Path]:
    """The protocol's implementation files (the spec's enforcement scope)."""
    src = pathlib.Path(__file__).resolve().parents[3]
    return [
        src / "repro_torch/core/metalog.py",
        src / "repro_torch/core/range_shard.py",
        src / "repro_torch/core/shard.py",
        src / "repro_torch/core/store.py",
        src / "repro_torch/elastic/remap.py",
    ]


def check_paths(paths=None, *, spec: ProtocolSpec = WAL_SPEC,
                require_complete: bool = False) -> list[Violation]:
    """Check files against the spec; with ``require_complete``, also demand
    that every spec kind is appended somewhere in the analyzed tree."""
    paths = default_targets() if paths is None else list(paths)
    violations: list[Violation] = []
    appended: set[str] = set()
    for p in paths:
        p = pathlib.Path(p)
        v, sites = check_source(p.read_text(encoding="utf-8"), str(p),
                                spec=spec)
        violations.extend(v)
        appended |= {s.kind for s in sites if s.kind}
    if require_complete:
        missing = spec.kind_names - appended
        if missing:
            violations.append(Violation(
                str(paths[0]), 0, "unappended-kind",
                f"spec kind(s) {sorted(missing)} are declared in "
                f"{spec.name} but never appended in the analyzed tree — "
                "dead spec entries hide protocol drift"))
    return violations


def append_site_inventory(paths=None, *,
                          spec: ProtocolSpec = WAL_SPEC) -> list[AppendSite]:
    """Every statically resolved append site in ``paths`` (default: the
    protocol implementation files).  The crash-point harness derives its
    required kind coverage from this inventory — see
    ``tests/test_crashpoints.py::test_spec_derived_crash_coverage``."""
    paths = default_targets() if paths is None else list(paths)
    sites: list[AppendSite] = []
    for p in paths:
        p = pathlib.Path(p)
        _v, s = check_source(p.read_text(encoding="utf-8"), str(p), spec=spec)
        sites.extend(s)
    return sites


__all__ = [
    "AppendSite", "PROTOCOL_RULES", "append_site_inventory", "check_paths",
    "check_source", "default_targets",
]
