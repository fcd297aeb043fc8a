"""``# contract:`` annotation parsing shared by the lint rules.

Annotations are ordinary comments so they cost nothing at runtime and need no
imports in the annotated modules.  The grammar:

    # contract: <spec>[, <spec>...]

where each ``<spec>`` is a marker name, optionally with a parenthesized
argument.  Two kinds of marker exist:

* **Function-level** markers describe the whole enclosing function and are
  valid on the ``def`` line, a decorator line, the line immediately above the
  ``def``/first decorator, or any line between the ``def`` and the first body
  statement (i.e. alongside the docstring):

  - ``coordinator-only`` — runs only on the coordinator thread (the single
    submitter); may create locks and mutate front-end counters unlocked.
  - ``record-then-apply`` — every topology mutation must follow the
    function's first ``metalog.append`` record call.
  - ``flush-before-record`` — the function's first ``flush``/``flush_all``
    call must precede its first durable-record write.
  - ``rename-before-truncate`` — the function's first ``.truncate(...)``
    call must follow its first replacement write (``metalog.append`` /
    ``os.replace`` / ``os.rename``): history may only be dropped after the
    state it summarized has been durably republished.
  - ``single-threaded`` — a modeled hot path; must stay lock-free.

* **Line-level**: ``exempt(<reason>)`` suppresses every violation reported on
  its own line and on the next line.  An empty reason is itself a violation —
  suppressions must be justified in place.

Unknown marker names are reported (rule ``contract-annotation``) so a typo'd
annotation cannot silently disable a rule.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize

FUNCTION_MARKERS = frozenset(
    ["coordinator-only", "record-then-apply", "flush-before-record",
     "rename-before-truncate", "single-threaded"]
)
LINE_MARKERS = frozenset(["exempt"])
KNOWN_MARKERS = FUNCTION_MARKERS | LINE_MARKERS

_CONTRACT_RE = re.compile(r"#\s*contract:\s*(?P<specs>.+?)\s*$")
_SPEC_RE = re.compile(r"^(?P<name>[a-z][a-z-]*)(?:\((?P<arg>[^()]*)\))?$")


@dataclasses.dataclass(frozen=True)
class Annotation:
    """One parsed ``# contract:`` spec at a source line."""

    name: str
    arg: str | None
    lineno: int
    raw: str


@dataclasses.dataclass(frozen=True)
class Problem:
    """An annotation-hygiene defect (unknown marker, unjustified exempt)."""

    lineno: int
    message: str


def _parse_comments(source: str) -> tuple[list[Annotation], list[Problem]]:
    annotations: list[Annotation] = []
    problems: list[Problem] = []
    tokens = tokenize.generate_tokens(io.StringIO(source).readline)
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _CONTRACT_RE.search(tok.string)
        if m is None:
            continue
        lineno = tok.start[0]
        for raw in m.group("specs").split(","):
            raw = raw.strip()
            if not raw:
                continue
            sm = _SPEC_RE.match(raw)
            if sm is None:
                problems.append(Problem(lineno, f"unparseable contract spec {raw!r}"))
                continue
            name, arg = sm.group("name"), sm.group("arg")
            if name not in KNOWN_MARKERS:
                problems.append(
                    Problem(lineno, f"unknown contract marker {name!r} "
                                    f"(known: {', '.join(sorted(KNOWN_MARKERS))})")
                )
                continue
            if name == "exempt" and not (arg or "").strip():
                problems.append(
                    Problem(lineno, "exempt needs a justification: "
                                    "# contract: exempt(<reason>)")
                )
                continue
            annotations.append(Annotation(name, arg, lineno, raw))
    return annotations, problems


class ModuleContracts:
    """One source file's AST plus its parsed contract annotations.

    Provides the two lookups the rules need: the marker set of a function
    (:meth:`markers_of`, honoring lexical nesting via :meth:`has_marker`) and
    whether a given line is covered by an ``exempt`` (:meth:`exempted`).
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.annotations, self.problems = _parse_comments(source)
        self._by_line: dict[int, list[Annotation]] = {}
        for a in self.annotations:
            self._by_line.setdefault(a.lineno, []).append(a)
        self.exempt_lines: set[int] = set()
        for a in self.annotations:
            if a.name == "exempt":
                self.exempt_lines.update((a.lineno, a.lineno + 1))
        # innermost enclosing function per AST node, and marker set per function
        self.enclosing: dict[ast.AST, ast.AST | None] = {}
        self.functions: list[ast.AST] = []
        self._markers: dict[ast.AST, frozenset[str]] = {}
        self._walk(self.tree, None)

    # ------------------------------------------------------------- structure
    def _walk(self, node: ast.AST, func: ast.AST | None) -> None:
        for child in ast.iter_child_nodes(node):
            self.enclosing[child] = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(child)
                self._markers[child] = self._collect_markers(child)
                self._walk(child, child)
            else:
                self._walk(child, func)

    def _collect_markers(self, fn: ast.AST) -> frozenset[str]:
        first = min([d.lineno for d in fn.decorator_list] + [fn.lineno])
        last = fn.body[0].lineno - 1 if fn.body else fn.lineno
        lines = set(range(first - 1, last + 1))
        found = set()
        for lineno in lines:
            for a in self._by_line.get(lineno, ()):
                if a.name in FUNCTION_MARKERS:
                    found.add(a.name)
        return frozenset(found)

    # --------------------------------------------------------------- queries
    def markers_of(self, fn: ast.AST) -> frozenset[str]:
        return self._markers.get(fn, frozenset())

    def has_marker(self, node: ast.AST, marker: str) -> bool:
        """True if ``node``'s enclosing function — or any outer function it is
        nested in — carries ``marker``."""
        fn = self.enclosing.get(node)
        while fn is not None:
            if marker in self._markers.get(fn, frozenset()):
                return True
            fn = self.enclosing.get(fn)
        return False

    def exempted(self, lineno: int) -> bool:
        return lineno in self.exempt_lines

    def functions_with(self, marker: str):
        for fn in self.functions:
            if marker in self._markers[fn]:
                yield fn


__all__ = [
    "Annotation",
    "FUNCTION_MARKERS",
    "KNOWN_MARKERS",
    "LINE_MARKERS",
    "ModuleContracts",
    "Problem",
]
