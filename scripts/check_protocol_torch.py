#!/usr/bin/env python3
"""WAL-protocol conformance CLI: the CI hard gate for the record protocol.

    python scripts/check_protocol_torch.py               # check the protocol tree
    python scripts/check_protocol_torch.py --self-test   # prove every rule fires
    python scripts/check_protocol_torch.py --json        # machine-readable output
    python scripts/check_protocol_torch.py path.py ...   # check explicit files

Default targets are the protocol's implementation files —
``src/repro_torch/core/{metalog,range_shard,shard,store}.py`` and
``src/repro_torch/elastic/remap.py`` — checked against
``repro_torch.analysis.protocol.spec.WAL_SPEC`` with completeness on (every spec
kind must be appended somewhere).  Explicit paths are checked without the
completeness requirement.  Exit codes: 0 clean, 1 violations found,
2 self-test/usage failure.

``--self-test`` runs the seeded-violation fixtures so rules cannot silently
rot: every ``tests/fixtures/protocol_bad/*.py`` declares its planted rules
with ``# protocol-expect: <rule>`` lines (and opts into the completeness
check with ``# protocol-flags: require-complete``) and must produce exactly
that rule set; every ``tests/fixtures/protocol_good/*.py`` must check clean;
and every registered rule must be covered by at least one bad fixture.

``--json`` emits ``{"violations": [{"path", "line", "rule", "message"}],
"files": N}``; the default text format (``path:line: [rule] message``) is
matched by ``.github/problem-matchers/repro-analysis.json`` so CI annotates
the offending diff lines.
"""
from __future__ import annotations

import json
import pathlib
import re
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.analysis.protocol.static_check import (  # noqa: E402
    PROTOCOL_RULES,
    check_paths,
    default_targets,
)

_EXPECT_RE = re.compile(r"#\s*protocol-expect:\s*([a-z-]+)\s*$", re.MULTILINE)
_FLAGS_RE = re.compile(r"#\s*protocol-flags:\s*([a-z -]+?)\s*$", re.MULTILINE)


def _fixture_flags(text: str) -> set[str]:
    flags: set[str] = set()
    for m in _FLAGS_RE.findall(text):
        flags.update(m.split())
    return flags


def self_test() -> int:
    bad_dir = REPO_ROOT / "tests/fixtures/protocol_bad"
    good_dir = REPO_ROOT / "tests/fixtures/protocol_good"
    failures: list[str] = []
    covered: set[str] = set()

    bad = sorted(bad_dir.glob("*.py"))
    if not bad:
        failures.append(f"no bad fixtures found under {bad_dir}")
    for path in bad:
        text = path.read_text(encoding="utf-8")
        expected = set(_EXPECT_RE.findall(text))
        if not expected:
            failures.append(
                f"{path}: bad fixture declares no '# protocol-expect:' rules")
            continue
        complete = "require-complete" in _fixture_flags(text)
        actual = {v.rule for v in
                  check_paths([path], require_complete=complete)}
        if actual != expected:
            failures.append(
                f"{path}: expected rule set {sorted(expected)}, checker "
                f"produced {sorted(actual)}")
        covered |= expected & actual

    for path in sorted(good_dir.glob("*.py")):
        text = path.read_text(encoding="utf-8")
        complete = "require-complete" in _fixture_flags(text)
        for v in check_paths([path], require_complete=complete):
            failures.append(f"{path}: good fixture tripped {v}")

    missing = set(PROTOCOL_RULES) - covered
    if missing:
        failures.append(
            f"rules with no seeded bad-fixture coverage: {sorted(missing)} "
            f"(add a planted violation under {bad_dir})")

    if failures:
        print("protocol self-test FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 2
    print(f"protocol self-test ok: {len(bad)} bad fixtures, "
          f"{len(PROTOCOL_RULES)} rules covered")
    return 0


def main(argv: list[str]) -> int:
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return 0
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if "--self-test" in argv:
        rest = [a for a in argv if a != "--self-test"]
        if rest:
            print(f"error: --self-test takes no paths, got {rest!r}",
                  file=sys.stderr)
            return 2
        return self_test()
    unknown = [a for a in argv if a.startswith("-")]
    if unknown:
        print(f"error: unknown flag(s) {unknown!r}; see --help",
              file=sys.stderr)
        return 2
    if argv:
        targets = [pathlib.Path(a) for a in argv]
        require_complete = False
    else:
        targets = default_targets()
        require_complete = True
    missing = [t for t in targets if not t.is_file()]
    if missing:
        print(f"error: no such file(s): {[str(m) for m in missing]}",
              file=sys.stderr)
        return 2
    violations = check_paths(targets, require_complete=require_complete)
    if as_json:
        print(json.dumps({
            "violations": [
                {"path": v.path, "line": v.lineno, "rule": v.rule,
                 "message": v.message}
                for v in violations
            ],
            "files": len(targets),
        }, indent=2))
    else:
        for v in violations:
            print(v)
    if violations:
        print(f"{len(violations)} protocol violation(s) in "
              f"{len(targets)} file(s)", file=sys.stderr)
        return 1
    if not as_json:
        print(f"protocol ok: {len(targets)} files conform to the WAL spec")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
